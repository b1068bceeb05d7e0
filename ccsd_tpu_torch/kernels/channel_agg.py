"""Channel-folded GCN aggregation of the fused AttentionLayer: CUDA kernel,
plain version, wrapper.

Replaces ``agg_pallas`` (tools/probe_pallas_agg.py:43-51, body ``_agg_kernel``
:34-40) and ``agg_pallas_2d`` (:64-73, body ``_agg_kernel_2d`` :54-61), the
Pallas kernels of the ``agg`` contraction of the fused AttentionLayer
(ccsd_tpu/models/attention.py:226-234):

    nx[b, c, n, f] = sum_m norm[b, c, n, m] * x[b, m, f]

norm (B, C, N, N) and x (B, N, F) give (B, C, N, F), all f32.  The probes'
folded form, norm (B, C*N, N) -> (B, C*N, F), is the same call.  The probes
keep the batch last (in lanes); the port keeps it first.  The kernel is
``csrc/channel_agg.cu``.
"""

from __future__ import annotations

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import check_status, kernel_fn
from ccsd_tpu_torch.kernels.gcn import check_cuda_f32
from ccsd_tpu_torch.kernels.gmh_attention import SMEM_LIMIT

ROWS_PER_BLOCK = 16  # kRows of csrc/channel_agg.cu


def channel_agg_plain(norm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """norm (B, C, N, N) or (B, C*N, N), x (B, N, F) -> (B, C, N, F) or
    (B, C*N, F)."""
    return norm @ (x if norm.dim() == 3 else x[:, None])


def channel_agg(norm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Channel-folded aggregation: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return channel_agg_plain(norm, x)
    check_cuda_f32("channel_agg", norm=norm, x=x)
    B, N, F = x.shape
    if norm.dim() not in (3, 4) or norm.shape[0] != B or norm.shape[-1] != N \
            or (norm.dim() == 4 and norm.shape[2] != N):
        raise ValueError(f"channel_agg: norm {tuple(norm.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    R = norm[0].numel() // N  # rows: C * N
    smem = 4 * (ROWS_PER_BLOCK * N + N * F)
    if smem > SMEM_LIMIT:
        raise ValueError(f"channel_agg: N={N}, F={F} need {smem} B of shared "
                         f"memory (limit {SMEM_LIMIT})")
    out = torch.empty((*norm.shape[:-1], F), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("channel_agg")(norm.data_ptr(), x.data_ptr(), out.data_ptr(),
                                      B, R, N, F, stream)
    check_status("channel_agg", status)
    LAUNCHES["channel_agg"] += 1
    return out
