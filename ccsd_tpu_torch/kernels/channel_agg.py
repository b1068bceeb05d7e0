"""Channel-folded GCN aggregation of the fused AttentionLayer, with the
normalisation inside: CUDA kernel, plain version, wrapper.

Replaces ``agg_pallas`` (tools/probe_pallas_agg.py:43-51, body ``_agg_kernel``
:34-40) and ``agg_pallas_2d`` (:64-73, body ``_agg_kernel_2d`` :54-61), the
Pallas kernels of the ``agg`` contraction of the fused AttentionLayer
(ccsd_tpu/models/attention.py:226-234), together with the ``gcn_norm`` the
layer applies before it (:244):

    nx[b, c, n, f] = sum_m norm[b, c, n, m] * x[b, m, f],  norm = gcn_norm(adj)

adj (B, C, N, N) in any strides (the channels-last view a previous layer
leaves needs no copy) and x (B, N, F) give (B, C, N, F), all f32.  The
probes' folded form, adj (B, C*N, N) -> (B, C*N, F), is the same call: the
degree of column m of channel c is the sum of row c*N + m.  bf16 adj and x
(N <= 64) give a bf16 output, the f32 plain version's rounded once.  The
probes keep
the batch last (in lanes); the port keeps it first.  ``bf16=True`` is
``agg_impl="dot_bf16"``: norm and x rounded to bf16, products summed in f32
(the layer rounds the output).  The kernel is ``csrc/channel_agg.cu``; for
N > 64 it reads the degrees of a ``gcn_degrees`` launch
(``kernels/gcn.py``) and takes blocks of ``AGG_ROWS`` rows and
``agg_group(C)`` channels: the normalised aggregation tile of
``csrc/agg_tile.cuh`` on the tensor cores (3xTF32, f32-accurate).
"""

from __future__ import annotations

import functools

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import check_status, kernel_fn
from ccsd_tpu_torch.kernels.gcn import (
    agg_group,
    check_bf16_size,
    check_cuda,
    check_smem,
    check_strided,
    gcn_degrees,
    gcn_norm,
    kernel_dtype,
    plain_in_f32,
    rows_per_block,
)
from ccsd_tpu_torch.kernels.gmh_scores import round_bf16


def _channels(adj: torch.Tensor, N: int) -> torch.Tensor:
    """adj as (B, C, N, N): the folded (B, C*N, N) form unflattened."""
    return adj if adj.dim() == 4 else adj.unflatten(1, (-1, N))


def channel_agg_plain(adj: torch.Tensor, x: torch.Tensor,
                      bf16: bool = False) -> torch.Tensor:
    """adj (B, C, N, N) or (B, C*N, N), x (B, N, F) -> (B, C, N, F) or
    (B, C*N, F)."""
    norm = gcn_norm(_channels(adj, x.shape[1]))
    if bf16:
        norm, x = round_bf16(norm), round_bf16(x)
    return (norm @ x[:, None]).reshape(*adj.shape[:-1], x.shape[-1])


@functools.lru_cache(maxsize=None)
def agg_smem(N: int, C: int, F: int) -> int:
    """Shared bytes of a block of csrc/channel_agg.cu (the library's own
    count); raises where it exceeds the card's limit."""
    nbytes = kernel_fn("channel_agg", "channel_agg_smem")(N, F, rows_per_block(N), agg_group(C))
    check_smem("channel_agg", nbytes, N=N, C=C, F=F)
    return nbytes


def channel_agg(adj: torch.Tensor, x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """Normalised channel-folded aggregation: the CUDA kernel for CUDA
    tensors (bf16 tensors, N <= 64: its bf16 variant, one graph-channel a
    block, the output in bf16), the plain version for CPU tensors."""
    dt = kernel_dtype("channel_agg", adj=adj, x=x)
    if x.device.type == "cpu":
        return plain_in_f32(channel_agg_plain, dt, adj, x, bf16)
    check_cuda("channel_agg", dt, x=x)
    check_strided("channel_agg", "adj", adj, x.device, dt)
    B, N, F = x.shape
    fits = adj.shape[0] == B and adj.shape[-1] == N and (
        (adj.dim() == 4 and adj.shape[2] == N) or (adj.dim() == 3 and adj.shape[1] % N == 0))
    if not fits:
        raise ValueError(f"channel_agg: adj {tuple(adj.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    a4 = _channels(adj, N)
    C = a4.shape[1]
    if dt == torch.bfloat16:
        check_bf16_size("channel_agg", N)
    agg_smem(N, C, F)
    out = torch.empty((*adj.shape[:-1], F), dtype=dt, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if dt == torch.bfloat16:
        status = kernel_fn("channel_agg", "channel_agg_bf16_run")(
            a4.data_ptr(), x.data_ptr(), out.data_ptr(), B, C, N, F, *a4.stride(), int(bf16),
            stream)
        check_status("channel_agg", status)
        LAUNCHES["channel_agg"] += 1
        return out
    rows = rows_per_block(N)
    deg = gcn_degrees(a4) if rows < N else None
    status = kernel_fn("channel_agg")(
        a4.data_ptr(), x.data_ptr(), 0 if deg is None else deg.data_ptr(), out.data_ptr(),
        B, C, N, F, *a4.stride(), rows, agg_group(C), int(bf16), stream)
    check_status("channel_agg", status)
    LAUNCHES["channel_agg"] += 1
    return out
