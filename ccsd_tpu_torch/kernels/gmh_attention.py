"""Graph multi-head (GMH) attention over all channels of a layer: CUDA
kernel, plain version, wrapper.

Replaces ``gmh_attention_pallas`` (ccsd_tpu/ops/pallas/gmh_attention.py:
62-114, body ``_gmh_kernel`` :30-59).  Per graph b and channel c:

    norm    = D^-1/2 A'_c D^-1/2       (A'_c: diagonal set to ``loop``)
    Q, K, V = norm (X W_{q,k,v}[c]) + b_{q,k,v}[c]
    S_h     = Q_h K_h^T / sqrt(F_out)  (head h = channels [h*ds, (h+1)*ds))
    A       = mean_h tanh(S_h);  returns (V, (A + A^T) / 2)

One launch covers the C channels of an AttentionLayer: weights come
stacked as (C, F_in, .) and the adjacency as (B, C, N, N), in any strides
(the kernel takes all four, so the channels-last view a previous layer
leaves needs no copy).  A block takes one (graph, channel).  The outputs
are written in the layouts AttentionLayer consumes next, and the plain
version returns the same: V concatenated over channels as (B, N, C * F_out),
and the maps channels-last as (B, N, N, C).

With ``add_loop=False`` the diagonal is kept as given, following
``gcn_norm`` (ccsd_tpu/models/gcn.py:31-33); the Pallas body writes 0 there
instead, which no model path reaches.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import check_status, kernel_fn
from ccsd_tpu_torch.kernels.gcn import check_cuda_f32, check_smem, check_strided_f32, gcn_norm

# one block of the attention kernels holds a whole graph's channel
# (gmh_attention) or a graph's Q, K and N x N head sums (gmh_scores)
MAX_N = 64


def head_split(attn_dim: int, num_heads: int) -> Tuple[int, int]:
    """(effective heads, head_dim) of torch's ``Q.split(attn_dim // H, 2)``."""
    ds = attn_dim // num_heads
    if ds == 0 or attn_dim % ds:
        raise ValueError(
            f"attn_dim={attn_dim} not splittable into equal chunks of "
            f"attn_dim // num_heads = {ds}"
        )
    return attn_dim // ds, ds


def gmh_attention_plain(x, adj, wq, bq, wk, bk, wv, bv, num_heads: int,
                        out_dim: int, loop: float = 1.0,
                        add_loop: bool = True):
    """x (B, N, F_in), adj (B, C, N, N), w* (C, F_in, .), b* (C, .) or None
    -> (V (B, N, C * F_out), A (B, N, N, C))."""
    norm = gcn_norm(adj, add_loop, loop)  # (B, C, N, N)

    def conv(w, b):
        out = norm @ torch.einsum("bnf,cfo->bcno", x, w)
        return out if b is None else out + b[None, :, None, :]

    Q, K, V = conv(wq, bq), conv(wk, bk), conv(wv, bv)
    B, C, N, A = Q.shape
    H, ds = head_split(A, num_heads)
    Qh = Q.reshape(B, C, N, H, ds)
    Kh = K.reshape(B, C, N, H, ds)
    s = torch.einsum("bcnhd,bcmhd->bchnm", Qh, Kh) / math.sqrt(out_dim)
    att = torch.tanh(s).mean(dim=2)
    att = (att + att.transpose(-1, -2)) / 2
    v = V.permute(0, 2, 1, 3).reshape(B, N, C * V.shape[-1])
    return v, att.permute(0, 2, 3, 1).contiguous()


def fit_graph(name: str, N: int, smem: Callable[[], int]) -> int:
    """Shared bytes of one block over a graph of N nodes, ``smem()`` being
    the kernel's own count (a query of its library, called only for
    N <= MAX_N).  Raises a ``ValueError`` naming N where one block cannot
    hold the graph."""
    if N > MAX_N:
        raise ValueError(f"{name}: N={N} exceeds the one-block graph of the kernel "
                         f"(N <= {MAX_N}); larger graphs need a tiled design")
    nbytes = smem()
    check_smem(name, nbytes, N=N)
    return nbytes


@functools.lru_cache(maxsize=None)
def attention_smem(N: int, Fi: int, A: int, O: int, H: int) -> int:
    """Shared bytes of one block of csrc/gmh_attention.cu, one (graph,
    channel); raises as :func:`fit_graph`."""
    return fit_graph("gmh_attention", N,
                     lambda: kernel_fn("gmh_attention", "gmh_attention_smem")(N, Fi, A, O, H))


def gmh_attention(x: torch.Tensor, adj: torch.Tensor, wq, bq, wk, bk, wv, bv,
                  num_heads: int, out_dim: int, loop: float = 1.0,
                  add_loop: bool = True):
    """GMH attention of all channels: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if x.device.type == "cpu":
        return gmh_attention_plain(x, adj, wq, bq, wk, bk, wv, bv, num_heads,
                                   out_dim, loop, add_loop)
    check_cuda_f32("gmh_attention", x=x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv)
    check_strided_f32("gmh_attention", "adj", adj, x.device)
    B, N, Fi = x.shape
    C, _, A = wq.shape
    O = wv.shape[-1]
    H, ds = head_split(A, num_heads)
    want = {"adj": (B, C, N, N), "wq": (C, Fi, A), "wk": (C, Fi, A),
            "wv": (C, Fi, O), "bq": (C, A), "bk": (C, A), "bv": (C, O)}
    got = {"adj": adj, "wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv}
    for k, shape in want.items():
        if got[k] is not None and tuple(got[k].shape) != shape:
            raise ValueError(f"gmh_attention: {k} has shape "
                             f"{tuple(got[k].shape)}, expected {shape}")
    attention_smem(N, Fi, A, O, H)
    v_out = torch.empty((B, N, C * O), dtype=torch.float32, device=x.device)
    a_out = torch.empty((B, N, N, C), dtype=torch.float32, device=x.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gmh_attention")(
        x.data_ptr(), adj.data_ptr(), wq.data_ptr(), ptr(bq), wk.data_ptr(),
        ptr(bk), wv.data_ptr(), ptr(bv), v_out.data_ptr(), a_out.data_ptr(),
        B, C, N, Fi, A, O, H, ds, *adj.stride(), math.sqrt(out_dim),
        int(add_loop), float(loop), stream,
    )
    check_status("gmh_attention", status)
    LAUNCHES["gmh_attention"] += 1
    return v_out, a_out
