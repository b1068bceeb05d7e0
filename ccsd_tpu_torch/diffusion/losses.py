"""Score wrapper and the denoising score-matching (DSM) loss of the graph
score networks.

Port of ``get_score_fn`` (ccsd_tpu/diffusion/losses.py:49-73): VP and subVP
scale the network output by -1/std(t); VE returns it as it is.  And of
``get_sde_loss_fn`` (:102-163), split in two: :meth:`SDELoss.draw` draws t
and the masked noise of x and the adjacency from an explicit
``torch.Generator`` (t, then z_x, then z_adj), and :meth:`SDELoss.losses`
takes the draws as arguments, so a test can feed it the JAX package's.
The networks are arguments of the call, as the JAX loss takes their
parameters, so one loss serves the trained networks and their EMA copies.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ccsd_tpu_torch.diffusion.sde import SDE, VESDE, _bcast, is_vp_like
from ccsd_tpu_torch.ops.masks import gen_noise, mask_adjs, mask_x, node_flags


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


def _reduce(losses: torch.Tensor, reduce_mean: bool) -> torch.Tensor:
    flat = losses.reshape(losses.shape[0], -1)
    return flat.mean(dim=-1) if reduce_mean else 0.5 * flat.sum(dim=-1)


class SDELoss:
    """DSM loss for (X, A): ``loss(model_x, model_adj, x, adj, generator)
    -> (loss_x, loss_adj)``, each the batch mean."""

    def __init__(self, sde_x: SDE, sde_adj: SDE, reduce_mean: bool = False,
                 likelihood_weighting: bool = False, eps: float = 1e-5):
        self.sde_x, self.sde_adj = sde_x, sde_adj
        self.reduce_mean = reduce_mean
        self.likelihood_weighting = likelihood_weighting
        self.eps = eps

    def draw(self, x: torch.Tensor, adj: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t (B,), z_x, z_adj): t uniform in [eps, T), Gaussian noise masked
        by the adjacency's node flags, symmetric with a zero diagonal for
        the adjacency."""
        flags = node_flags(adj)
        u = torch.rand((adj.shape[0],), generator=generator, dtype=adj.dtype,
                       device=adj.device)
        t = u * (self.sde_adj.T - self.eps) + self.eps
        z_x = gen_noise(x, flags, sym=False, generator=generator)
        z_adj = gen_noise(adj, flags, sym=True, generator=generator)
        return t, z_x, z_adj

    def losses(self, model_x, model_adj, x: torch.Tensor, adj: torch.Tensor,
               t: torch.Tensor, z_x: torch.Tensor, z_adj: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The losses at given draws (ccsd_tpu/diffusion/losses.py:133-161)."""
        sde_x, sde_adj = self.sde_x, self.sde_adj
        flags = node_flags(adj)
        mean_x, std_x = sde_x.marginal_prob(x, t)
        perturbed_x = mask_x(mean_x + _bcast(std_x, x) * z_x, flags)
        mean_adj, std_adj = sde_adj.marginal_prob(adj, t)
        perturbed_adj = mask_adjs(mean_adj + _bcast(std_adj, adj) * z_adj, flags)

        score_x = get_score_fn(sde_x, model_x)(perturbed_x, perturbed_adj, flags, t)
        score_adj = get_score_fn(sde_adj, model_adj)(perturbed_x, perturbed_adj, flags, t)

        if not self.likelihood_weighting:
            lx = _reduce(torch.square(score_x * _bcast(std_x, score_x) + z_x),
                         self.reduce_mean)
            la = _reduce(torch.square(score_adj * _bcast(std_adj, score_adj) + z_adj),
                         self.reduce_mean)
        else:
            g2_x = sde_x.sde(torch.zeros_like(x), t)[1] ** 2
            lx = _reduce(torch.square(score_x + z_x / _bcast(std_x, z_x)),
                         self.reduce_mean) * g2_x
            g2_adj = sde_adj.sde(torch.zeros_like(adj), t)[1] ** 2
            la = _reduce(torch.square(score_adj + z_adj / _bcast(std_adj, z_adj)),
                         self.reduce_mean) * g2_adj
        return lx.mean(), la.mean()

    def __call__(self, model_x, model_adj, x: torch.Tensor, adj: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.losses(model_x, model_adj, x, adj, *self.draw(x, adj, generator))


def get_sde_loss_fn(sde_x: SDE, sde_adj: SDE, reduce_mean: bool = False,
                    likelihood_weighting: bool = False, eps: float = 1e-5) -> SDELoss:
    """DSM loss for (X, A) (ccsd_tpu/diffusion/losses.py:109-163)."""
    return SDELoss(sde_x, sde_adj, reduce_mean, likelihood_weighting, eps)
