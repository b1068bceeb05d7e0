"""Degree-normalised GCN aggregation: CUDA kernel, plain version, wrapper.

Replaces ``gcn_aggregate_pallas`` (ccsd_tpu/ops/pallas/gcn.py:45-85, body
``_gcn_kernel`` :31-42).  Per graph b:

    A'  = A with the diagonal set to ``loop`` (1.0, or 2.0 when improved)
    d   = max(rowsum A', 1)^-1/2
    out = (d ⊙ A' ⊙ d^T) (X W) + bias

The kernel is ``csrc/gcn_aggregate.cu``.  With ``add_loop=False`` the
diagonal is kept as given, as ``gcn_norm`` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import check_status, kernel_fn

MAX_N = 64  # one shared-memory tile per graph; larger N needs a K-loop
MAX_F = 128


def gcn_norm(adj: torch.Tensor, add_loop: bool = True,
             loop: float = 1.0) -> torch.Tensor:
    """Symmetric degree normalisation; the diagonal is assigned, not added.

    Port of ccsd_tpu/models/gcn.py:23-35: the degree is clamped to >= 1
    before the inverse square root.
    """
    if add_loop:
        n = adj.shape[-1]
        eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
        adj = adj * (1.0 - eye) + loop * eye
    dis = adj.sum(dim=-1).clamp(min=1.0).pow(-0.5)
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
    if N > MAX_N or Fi > MAX_F or Fo > MAX_F:
        raise ValueError(
            f"gcn_aggregate: N={N}, F_in={Fi}, F_out={Fo} exceed the kernel's "
            f"single tile (N <= {MAX_N}, F <= {MAX_F})"
        )
    out = torch.empty((B, N, Fo), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gcn_aggregate")(
        x.data_ptr(), adj.data_ptr(), weight.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        B, N, Fi, Fo, int(add_loop), float(loop), stream,
    )
    check_status("gcn_aggregate", status)
    LAUNCHES["gcn_aggregate"] += 1
    return out
