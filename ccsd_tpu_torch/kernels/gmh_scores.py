"""Head scores of the fused AttentionLayer: CUDA kernel, plain version,
wrapper.

Replaces ``make_pallas_reg(dtype, nc)`` (tools/pallas_scores_probe.py:85-104,
body ``_scores_reg_kernel`` :66-82) and ``make_pallas(dtype)`` (:127-146,
body ``_scores_kernel`` :109-124), the Pallas kernels of the head scores of
the fused AttentionLayer (ccsd_tpu/models/attention.py:296-327):

    att[b, c, n, m] = (1/H) sum_h tanh(sum_d Q[b,c,n,h*ds+d] K[b,c,m,h*ds+d] / sqrt(O))

Q, K (B, C, N, A) f32, head h = columns [h*ds, (h+1)*ds) as torch's
``Q.split(A // H, -1)`` cuts them; O is the layer's ``conv_output_dim``.
``gmh_scores`` returns the map symmetrised and channels-last, (B, N, N, C),
as the layer consumes it (attention.py:327, :332); ``head_scores`` is the
map before that, in the probes' (B, C, N, N) order.

``bf16=True`` is ``scores_impl="mulreduce_h_bf16"`` (and ``"dot_bf16"``):
Q and K rounded to bf16, products exact in f32, each head's sum rounded to
bf16 once, tanh and the head mean in f32 -- where XLA rounds the JAX
expression.  The probes' bf16 kernels round at every add instead, so they
differ from this by a few bf16 ulps of the sum (tests/test_torch_fused_kernels.py).
The kernel is ``csrc/gmh_scores.cu``: one block per graph and group of
channels (``channel_group``), the bf16 head products on the tensor cores.
Above N = 64 (``MAX_N``) a block cannot hold a graph's Q, K and N x N head
sums, and one launch of the tile-pair stage of ``csrc/gmh_common.cuh``
takes over: a block per pair of ``TILE``-row tiles of the plan
``tile_pairs(N)`` (kernels/gmh_attention.py) for a group of at most
``TILED_MAX_GROUP`` channels, each entry's two directions in one thread,
with the same rounding points (bf16: the head products on the tensor
cores, Q and K rounded as the operands are packed, the tanh from the
approximate exp2 and reciprocal, within 6e-7 of tanh).

bf16 Q and K (the bf16 networks', N <= 64) take the kernel's bf16 variant:
staged as f32, so ``bf16=True`` packs the same bits it would pack from
their f32 values, and the map is written in bf16, each entry rounded once.
"""

from __future__ import annotations

import functools
import math

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import SMEM_LIMIT, check_status, kernel_fn
from ccsd_tpu_torch.kernels.gcn import check_bf16_size, check_cuda, kernel_dtype, plain_in_f32
from ccsd_tpu_torch.kernels.gmh_attention import (
    H100_SMS,
    MAX_N,
    channel_group,
    device_sms,
    fit_graph,
    head_split,
    pair_plan,
    tiled_scores_group,
)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 (ties to even) -> f32."""
    return t.to(torch.bfloat16).float()


def head_scores(q: torch.Tensor, k: torch.Tensor, num_heads: int, out_dim: int,
                bf16: bool = False) -> torch.Tensor:
    """Plain head-mean tanh scores: q, k (B, C, N, A) -> (B, C, N, N)."""
    B, C, N, A = q.shape
    H, ds = head_split(A, num_heads)
    if bf16:
        q, k = round_bf16(q), round_bf16(k)
    s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, ds),
                     k.reshape(B, C, N, H, ds))
    if bf16:
        s = round_bf16(s)
    return torch.tanh(s / math.sqrt(out_dim)).mean(dim=2)


def gmh_scores_plain(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                     out_dim: int, bf16: bool = False) -> torch.Tensor:
    """q, k (B, C, N, A) -> symmetrised map, channels-last (B, N, N, C)."""
    att = head_scores(q, k, num_heads, out_dim, bf16)
    return ((att + att.transpose(-1, -2)) / 2).permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=None)
def scores_group(B: int, C: int, N: int, A: int, H: int, bf16: bool,
                 sms: int = H100_SMS) -> int:
    """G of a csrc/gmh_scores.cu launch, with the kernel's own count of the
    shared memory of a block; raises as ``fit_graph``."""
    def smem(g: int) -> int:
        return kernel_fn("gmh_scores", "gmh_scores_smem")(N, A, H, g, int(bf16))

    fit_graph("gmh_scores", N, lambda: smem(1))
    return channel_group(B, C, sms, lambda g: smem(g) <= SMEM_LIMIT)


def gmh_scores(q: torch.Tensor, k: torch.Tensor, num_heads: int, out_dim: int,
               bf16: bool = False) -> torch.Tensor:
    """Head scores: the CUDA kernel for CUDA tensors (bf16 q and k, N <=
    64: its bf16 variant, the map in bf16), the plain version for CPU
    tensors.  On the card q and k may be strided views whose last
    dimension is dense."""
    dt = kernel_dtype("gmh_scores", q=q, k=k)
    if q.device.type == "cpu":
        return plain_in_f32(gmh_scores_plain, dt, q, k, num_heads, out_dim, bf16)
    check_cuda("gmh_scores", dt, dense_rows=True, q=q, k=k)
    if q.dim() != 4 or k.shape != q.shape:
        raise ValueError(f"gmh_scores: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "must both be (B, C, N, A)")
    B, C, N, A = q.shape
    H, ds = head_split(A, num_heads)
    if dt == torch.bfloat16:
        check_bf16_size("gmh_scores", N)
    out = torch.empty((B, N, N, C), dtype=dt, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if N > MAX_N:
        G = tiled_scores_group("gmh_scores", B, C, N, A, device_sms(q.device))
        pairs = pair_plan(N, q.device)
        status = kernel_fn("gmh_scores", "gmh_tiled_scores_run")(
            q.data_ptr(), k.data_ptr(), pairs.data_ptr(), out.data_ptr(), B, C, N, A, H, ds,
            G, pairs.shape[0], *q.stride()[:3], *k.stride()[:3], math.sqrt(out_dim),
            int(bf16), stream,
        )
    else:
        G = scores_group(B, C, N, A, H, bool(bf16), device_sms(q.device))
        status = kernel_fn("gmh_scores",
                           "gmh_scores_bf16_run" if dt == torch.bfloat16 else None)(
            q.data_ptr(), k.data_ptr(), out.data_ptr(), B, C, N, A, H, ds, G,
            *q.stride()[:3], *k.stride()[:3], math.sqrt(out_dim), int(bf16), stream,
        )
    check_status("gmh_scores", status)
    LAUNCHES["gmh_scores"] += 1
    return out
