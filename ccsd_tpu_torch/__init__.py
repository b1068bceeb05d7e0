"""PyTorch/CUDA port of ccsd_tpu for NVIDIA Hopper (H100).

The graph training and sampling paths of ``config/community_small.yaml``
and the grid family, the dense CC mode of
``config/community_small_CC.yaml`` and the two-stage CC model of
``config/community_small_CC_two_stage.yaml``, run here, with every Pallas kernel of
the JAX package replaced by a hand-written CUDA C++ kernel for ``sm_90a``
(``ccsd_tpu_torch/csrc``), and the two on the training path given backward
kernels of their own; the Hodge ops of CC mode are plain PyTorch, as they
are plain ``jnp`` in the JAX package.  The
package imports ``torch`` and ``numpy`` only; ``ccsd_tpu`` stays the
numerical reference.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper takes its plain PyTorch version.
"""

import torch


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none.

    Raises when no CUDA device is present: the port never falls back to the
    CPU silently (pass ``device="cpu"`` to run the plain path there).
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    return default_device() if device is None else torch.device(device)
