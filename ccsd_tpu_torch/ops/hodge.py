"""Hodge-dual operators on rank-2 incidence tensors.

Port of ccsd_tpu/ops/hodge.py:18-78: the Hodge Laplacian H = F Fᵀ, the
channel stack [F, HF, H²F, ...] of ScoreNetworkF, and the embedding of an
adjacency's strict upper triangle on the diagonal of an E × E matrix and
back.  Plain PyTorch (batched matrix products): the JAX package computes
these in plain ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ccsd_tpu_torch.ops.cells import ComplexSpec, edge_index, n_nodes_from_edges
from ccsd_tpu_torch.ops.masks import default_mask


def hodge_laplacian(rank2: torch.Tensor) -> torch.Tensor:
    """H = F Fᵀ over the last two dims."""
    return rank2 @ rank2.transpose(-1, -2)


def pow_tensor_cc(x: torch.Tensor, cnum: int,
                  hodge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, E, K) -> (B, cnum, E, K): [F, HF, H²F, ...] with H = (F Fᵀ) * mask,
    in the promoted dtype of F and the mask (as JAX's)."""
    if x.dim() == 2:
        x = x[None]
    H = hodge_laplacian(x)
    if hodge_mask is not None:
        H = H * (hodge_mask[None] if hodge_mask.dim() == 2 else hodge_mask)
    xc = [x]
    x_ = x
    for _ in range(cnum - 1):
        if H.dtype != x_.dtype:  # an f32 mask on a bf16 F: JAX promotes the product
            x_ = x_.to(H.dtype)
        x_ = torch.bmm(H, x_)
        xc.append(x_)
    return torch.stack(xc, dim=1)


@functools.lru_cache(maxsize=16)
def _edge_uv(N: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(edge_index(N), dtype=torch.int64, device=device)


def adj_to_hodgedual(adj: torch.Tensor) -> torch.Tensor:
    """(..., N, N) -> (..., E, E), E = C(N, 2): the strict upper triangle of
    A, edge rows in lexicographic order, on the diagonal."""
    uv = _edge_uv(adj.shape[-1], adj.device)
    return torch.diag_embed(adj[..., uv[:, 0], uv[:, 1]])


def hodgedual_to_adj(hodgedual: torch.Tensor) -> torch.Tensor:
    """(..., E, E) -> (..., N, N): the diagonal scattered back to both
    triangles (the inverse of ``adj_to_hodgedual``)."""
    N = n_nodes_from_edges(hodgedual.shape[-1])
    uv = _edge_uv(N, hodgedual.device)
    diag = torch.diagonal(hodgedual, dim1=-2, dim2=-1)
    adj = hodgedual.new_zeros(hodgedual.shape[:-2] + (N, N))
    adj[..., uv[:, 0], uv[:, 1]] = diag
    adj[..., uv[:, 1], uv[:, 0]] = diag
    return adj


def hodgedual_mask_from_spec(spec: ComplexSpec, device=None) -> torch.Tensor:
    return default_mask(spec.num_edges, device=device)
