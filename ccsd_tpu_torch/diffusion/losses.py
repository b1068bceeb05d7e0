"""Score wrapper of the graph score networks.

Port of ``get_score_fn`` (ccsd_tpu/diffusion/losses.py:49-73): VP and subVP
scale the network output by -1/std(t); VE returns it as it is.  The DSM
loss belongs to training and is not ported yet.
"""

from __future__ import annotations

from typing import Callable

from ccsd_tpu_torch.diffusion.sde import SDE, VESDE, _bcast, is_vp_like


def get_score_fn(sde: SDE, model) -> Callable:
    """Graph score function (x, adj, flags, t) -> score."""
    if is_vp_like(sde):

        def score_fn(x, adj, flags, t):
            out = model(x, adj, flags)
            return -out / _bcast(sde.marginal_std(t), out)

    elif isinstance(sde, VESDE):

        def score_fn(x, adj, flags, t):
            return model(x, adj, flags)

    else:
        raise NotImplementedError(f"SDE class {type(sde).__name__} not supported.")
    return score_fn
