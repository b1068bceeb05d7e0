"""Degree-normalised GCN aggregation: CUDA kernel, plain version, wrapper.

Replaces ``gcn_aggregate_pallas`` (ccsd_tpu/ops/pallas/gcn.py:45-85, body
``_gcn_kernel`` :31-42).  Per graph b:

    A'  = A with the diagonal set to ``loop`` (1.0, or 2.0 when improved)
    d   = max(rowsum A', 1)^-1/2
    out = (d ⊙ A' ⊙ d^T) (X W) + bias

The kernel is ``csrc/gcn_aggregate.cu``.  With ``add_loop=False`` the
diagonal is kept as given, as ``gcn_norm`` does.

A block of ``csrc/gcn_aggregate.cu`` or ``csrc/channel_agg.cu`` holds a
whole graph where N <= ``WHOLE_GRAPH_N`` and sums its degrees itself; a
larger graph (grid: N = 361) is cut into blocks of ``ROW_TILE`` rows, and
``gcn_degrees`` (``csrc/gcn_degrees.cu``, one more launch with a count of
its own) first computes d once per row for them to read.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import SMEM_LIMIT, check_status, kernel_fn

WHOLE_GRAPH_N = 64  # up to this N a block holds all rows of a graph
ROW_TILE = 32       # rows per block of a larger graph


def rows_per_block(N: int) -> int:
    """Rows of a graph (or graph-channel) that one block of the two
    normalising kernels takes."""
    return N if N <= WHOLE_GRAPH_N else ROW_TILE


def _with_loop(adj: torch.Tensor, loop: float) -> torch.Tensor:
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    return adj * (1.0 - eye) + loop * eye


def gcn_degrees_plain(adj: torch.Tensor, add_loop: bool = True,
                      loop: float = 1.0) -> torch.Tensor:
    """(..., N, N) -> d (..., N) = max(rowsum A', 1)^-1/2."""
    if add_loop:
        adj = _with_loop(adj, loop)
    return adj.sum(dim=-1).clamp(min=1.0).pow(-0.5)


def gcn_norm(adj: torch.Tensor, add_loop: bool = True,
             loop: float = 1.0) -> torch.Tensor:
    """Symmetric degree normalisation; the diagonal is assigned, not added.

    Port of ccsd_tpu/models/gcn.py:23-35: the degree is clamped to >= 1
    before the inverse square root.
    """
    if add_loop:
        adj = _with_loop(adj, loop)
    dis = gcn_degrees_plain(adj, add_loop=False)
    return dis[..., :, None] * adj * dis[..., None, :]


def gcn_aggregate_plain(x, adj, weight, bias=None, loop: float = 1.0,
                        add_loop: bool = True) -> torch.Tensor:
    """x (B, N, F_in), adj (B, N, N), weight (F_in, F_out) -> (B, N, F_out)."""
    out = gcn_norm(adj, add_loop, loop) @ (x @ weight)
    return out if bias is None else out + bias


def check_cuda_f32(name: str, dense_rows: bool = False,
                   **tensors: Optional[torch.Tensor]) -> None:
    """The checks every kernel wrapper makes before a launch.  With
    ``dense_rows`` a tensor need only have a unit stride in its last
    dimension (the kernel takes the other strides)."""
    dev = None
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on {dev}")
        dev = t.device
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected float32")
        if not (t.stride(-1) == 1 if dense_rows else t.is_contiguous()):
            raise ValueError(f"{name}: {arg} is not "
                             + ("dense in its last dimension" if dense_rows else "contiguous"))
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(f"{name}: the kernel has no backward yet")


def check_strided_f32(name: str, arg: str, t: torch.Tensor, device: torch.device) -> None:
    """The checks of a tensor the kernel reads through its strides."""
    if t.device != device or t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                         f"expected float32 on {device}")
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(f"{name}: the kernel has no backward yet")


def check_smem(name: str, nbytes: int, **dims: int) -> None:
    """Raise where a block needs more shared memory than the card has."""
    if nbytes > SMEM_LIMIT:
        shape = ", ".join(f"{k}={v}" for k, v in dims.items())
        raise ValueError(f"{name}: {shape} need {nbytes} B of shared memory for one "
                         f"block (limit {SMEM_LIMIT})")


def gcn_degrees(adj: torch.Tensor, add_loop: bool = True,
                loop: float = 1.0) -> torch.Tensor:
    """d of every row of adj (B, C, N, N), in any strides -> (B, C, N): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if adj.device.type == "cpu":
        return gcn_degrees_plain(adj, add_loop, loop)
    check_strided_f32("gcn_degrees", "adj", adj, adj.device)
    B, C, N, _ = adj.shape
    deg = torch.empty((B, C, N), dtype=torch.float32, device=adj.device)
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    status = kernel_fn("gcn_degrees")(adj.data_ptr(), deg.data_ptr(), B, C, N,
                                      *adj.stride(), int(add_loop), float(loop), stream)
    check_status("gcn_degrees", status)
    LAUNCHES["gcn_degrees"] += 1
    return deg


@functools.lru_cache(maxsize=None)
def gcn_aggregate_smem(N: int, Fi: int, Fo: int) -> int:
    """Shared bytes of a block of csrc/gcn_aggregate.cu (the library's own
    count); raises where it exceeds the card's limit."""
    nbytes = kernel_fn("gcn_aggregate", "gcn_aggregate_smem")(N, Fi, Fo, rows_per_block(N))
    check_smem("gcn_aggregate", nbytes, N=N, F_in=Fi, F_out=Fo)
    return nbytes


def gcn_aggregate(x: torch.Tensor, adj: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, loop: float = 1.0,
                  add_loop: bool = True) -> torch.Tensor:
    """GCN aggregation: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if x.device.type == "cpu":
        return gcn_aggregate_plain(x, adj, weight, bias, loop, add_loop)
    check_cuda_f32("gcn_aggregate", x=x, adj=adj, weight=weight, bias=bias)
    B, N, Fi = x.shape
    Fo = weight.shape[1]
    if adj.shape != (B, N, N) or weight.shape != (Fi, Fo) or (
        bias is not None and bias.shape != (Fo,)
    ):
        raise ValueError(
            f"gcn_aggregate: shapes x {tuple(x.shape)}, adj {tuple(adj.shape)}, "
            f"weight {tuple(weight.shape)} do not agree"
        )
    gcn_aggregate_smem(N, Fi, Fo)
    rows = rows_per_block(N)
    deg = gcn_degrees(adj[:, None], add_loop, loop) if rows < N else None
    out = torch.empty((B, N, Fo), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gcn_aggregate")(
        x.data_ptr(), adj.data_ptr(), 0 if deg is None else deg.data_ptr(),
        weight.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
        B, N, Fi, Fo, rows, int(add_loop), float(loop), stream,
    )
    check_status("gcn_aggregate", status)
    LAUNCHES["gcn_aggregate"] += 1
    return out
