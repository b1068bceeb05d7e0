"""Flag masking, noise generation and tensor powers for graphs and
rank-2 complexes.

Port of ccsd_tpu/ops/masks.py:26-170 (the graph part, and the static-
universe rank-2 masks and noise), :172-221 (the rank-2 masks and noise
over a per-sample candidate-cell universe, the two-stage model's) and
:223-235 (``mask_hodge_adjs``), and
``default_mask`` (ccsd_tpu/ops/hodge.py:23-25).  Noise comes from an
explicit ``torch.Generator`` in place of a JAX PRNG key.  The rank-2 masks
gather with the spec's edge endpoints and multiply by its cell membership,
held on each device once (``spec_tensor``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ccsd_tpu_torch.ops.cells import ComplexSpec


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


# --------------------------------------------------------------- complexes ---

@functools.lru_cache(maxsize=64)
def spec_tensor(spec: ComplexSpec, name: str, device: torch.device) -> torch.Tensor:
    """``spec.<name>`` (``edge_u``, ``edge_v`` as int64 indices,
    ``cell_mask`` as float32) on ``device``, made once per device."""
    a = np.asarray(getattr(spec, name))
    dtype = torch.float32 if a.dtype.kind == "f" else torch.int64
    return torch.as_tensor(a, dtype=dtype).to(device)


def edge_flags(spec: ComplexSpec, flags: torch.Tensor) -> torch.Tensor:
    """(B, E): 1 where both endpoints of the edge row are present."""
    u = spec_tensor(spec, "edge_u", flags.device)
    v = spec_tensor(spec, "edge_v", flags.device)
    return flags[:, u] * flags[:, v]


def cell_flags(spec: ComplexSpec, flags: torch.Tensor) -> torch.Tensor:
    """(B, K): 1 where every node of the cell column is present (the count
    of absent member nodes, one product with the (K, N) membership, is 0)."""
    M = spec_tensor(spec, "cell_mask", flags.device).to(flags.dtype)
    missing = (1.0 - flags) @ M.T
    return (missing < 0.5).to(flags.dtype)


def rank2_flags(spec: ComplexSpec, flags: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge flags (B, E), cell flags (B, K))."""
    return edge_flags(spec, flags), cell_flags(spec, flags)


def mask_rank2(rank2: torch.Tensor, spec: ComplexSpec,
               flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the rows of absent edges and the columns of cells with an absent
    node.  rank2: (B, E, K) or (B, C, E, K)."""
    if flags is None:
        return rank2
    fl, fr = (f.to(rank2.dtype) for f in rank2_flags(spec, flags))
    if rank2.dim() == 4:
        fl, fr = fl[:, None, :], fr[:, None, :]
    return rank2 * fl[..., :, None] * fr[..., None, :]


def gen_noise_rank2(x: torch.Tensor, spec: ComplexSpec, flags: Optional[torch.Tensor],
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gaussian noise shaped like x, masked by ``mask_rank2`` (not
    symmetrised)."""
    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return mask_rank2(z, spec, flags)


def cell_flags_dynamic(member: torch.Tensor, valid: torch.Tensor,
                       flags: torch.Tensor) -> torch.Tensor:
    """(B, K) flags of a per-sample cell universe: 1 where the slot is
    valid and every member node is present.  member: (B, K, N) 0/1; valid:
    (B, K) 0/1 (padding slots 0)."""
    missing = torch.einsum("bn,bkn->bk", 1.0 - flags, member)
    return (missing < 0.5).to(flags.dtype) * valid


def mask_rank2_dynamic(rank2: torch.Tensor, spec: ComplexSpec, member: torch.Tensor,
                       valid: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask (B, E, K) or (B, C, E, K) rank-2 tensors over a per-sample
    universe: the edge rows by the static spec, the columns by
    ``cell_flags_dynamic``; with no flags, the columns by ``valid`` only."""
    if flags is None:
        fr = valid.to(rank2.dtype)
        if rank2.dim() == 4:
            fr = fr[:, None, :]
        return rank2 * fr[..., None, :]
    fl = edge_flags(spec, flags).to(rank2.dtype)
    fr = cell_flags_dynamic(member, valid, flags).to(rank2.dtype)
    if rank2.dim() == 4:
        fl, fr = fl[:, None, :], fr[:, None, :]
    return rank2 * fl[..., :, None] * fr[..., None, :]


def gen_noise_rank2_dynamic(x: torch.Tensor, spec: ComplexSpec, member: torch.Tensor,
                            valid: torch.Tensor, flags: Optional[torch.Tensor],
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gaussian noise shaped like x, masked by ``mask_rank2_dynamic``."""
    z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
    return mask_rank2_dynamic(z, spec, member, valid, flags)


def mask_hodge_adjs(hodge_adjs: torch.Tensor, spec: ComplexSpec,
                    flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero the rows and columns of absent edges.  hodge_adjs: (B, E, E) or
    (B, C, E, E)."""
    if flags is None:
        return hodge_adjs
    f = edge_flags(spec, flags).to(hodge_adjs.dtype)
    if hodge_adjs.dim() == 4:
        f = f[:, None, :]
    return hodge_adjs * f[..., :, None] * f[..., None, :]
