"""Flag masking, noise generation and tensor powers for graphs.

Port of the graph part of ccsd_tpu/ops/masks.py:26-109 and
``default_mask`` (ccsd_tpu/ops/hodge.py:23-25).  Noise comes from an
explicit ``torch.Generator`` in place of a JAX PRNG key.
"""

from __future__ import annotations

from typing import Optional

import torch


def mask_x(x: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero node-feature rows of absent nodes.  x: (B, N, F); flags: (B, N)."""
    if flags is None:
        return x
    return x * flags[:, :, None].to(x.dtype)


def mask_adjs(adjs: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero rows and columns of absent nodes.  adjs: (B, N, N) or (B, C, N, N)."""
    if flags is None:
        return adjs
    f = flags.to(adjs.dtype)
    if adjs.dim() == 4:
        f = f[:, None, :]
    return adjs * f[..., :, None] * f[..., None, :]


def node_flags(adj: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Flags from |A| row sums."""
    flags = (adj.abs().sum(-1) > eps).to(torch.float32)
    if flags.dim() == 3:
        flags = flags[:, 0, :]
    return flags


def gen_noise(
    x: torch.Tensor,
    flags: Optional[torch.Tensor],
    sym: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Masked Gaussian noise shaped like x; symmetric zero-diagonal when sym."""
    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    if sym:
        z = torch.triu(z, diagonal=1)
        z = z + z.transpose(-1, -2)
        return mask_adjs(z, flags)
    return mask_x(z, flags)


def quantize(t: torch.Tensor, thr: float = 0.5) -> torch.Tensor:
    """Threshold to {0, 1}."""
    return torch.where(t < thr, 0.0, 1.0).to(t.dtype)


def pow_tensor(x: torch.Tensor, cnum: int) -> torch.Tensor:
    """Stack [A, A^2, ..., A^cnum] as channels: (B, N, N) -> (B, cnum, N, N)."""
    xc = [x]
    x_ = x
    for _ in range(cnum - 1):
        x_ = torch.bmm(x_, x)
        xc.append(x_)
    return torch.stack(xc, dim=1)


def default_mask(n: int, device=None) -> torch.Tensor:
    """All-ones minus identity."""
    return torch.ones((n, n), dtype=torch.float32, device=device) - torch.eye(
        n, dtype=torch.float32, device=device
    )
