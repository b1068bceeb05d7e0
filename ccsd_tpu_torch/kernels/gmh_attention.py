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

Above N = 64 (``MAX_N``; grid: N = 361) one block cannot hold a graph's
channel, and the wrapper takes three launches: ``gcn_degrees`` (the
degrees of every row, ``kernels/gcn.py``), ``gmh_projection`` (Q, K and V
of a tile of ``AGG_ROWS`` rows and ``projection_group`` channels a block:
the normalised aggregation tile of ``csrc/agg_tile.cuh`` on the tensor
cores in 3xTF32, then the product with the weights in f32 FMAs, Q and K
into a scratch) and the tile-pair score stage
of ``csrc/gmh_common.cuh`` in f32 over the plan of ``tile_pairs`` (counted
as ``gmh_attention``: it writes the maps).  The plan covers every pair of
tiles I <= J once; a block takes the entries (n, m) with n in tile I and m
in tile J (on a diagonal pair, n <= m), a thread both directions of its
entries, and writes (n, m) and (m, n): every entry of the map once.

With ``add_loop=False`` the diagonal is kept as given, following
``gcn_norm`` (ccsd_tpu/models/gcn.py:31-33); the Pallas body writes 0 there
instead, which no model path reaches.

On a CUDA tensor that needs a gradient the wrapper runs the forward kernel
inside a ``torch.autograd.Function`` whose backward is the kernel
``csrc/gmh_attention_bwd.cu`` (a block per (graph, channel), N <= 64; one
launch, its sums over graphs and channels ordered by the tickets of
``gcn.ticket_buffer``): the gradients of x, the adjacency (written in the
adjacency's own layout, so a later layer's channels-last adjacency gets a
channels-last gradient) and the six weights and biases.
``gmh_attention_bwd_plain`` writes the same gradients out by hand.  Above
N = 64 the backward takes five launches over the ``score_plan`` and
``bwd_plan``, each
counted under its own name: ``gcn_degrees``, ``gmh_projection`` (Q and K
recomputed), ``gmh_bwd_layout`` (dL/dA symmetrised and, for a
channels-last adjacency, the adjacency, both copied channel-major),
``gmh_score_grad`` (gQ and gK, a cluster of row-tile blocks a graph and
channel) and ``gmh_attention_bwd_tiled`` (the row-tile kernel that gives
every gradient).  Nothing of the forward is saved.

bf16 tensors (N <= 64) take the one-block kernel's bf16 variant
(``gmh_attention_bf16``): V and the map in bf16, the map exactly
symmetric; its plain version is ``kernels.gcn.plain_in_f32`` of
``gmh_attention_plain``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Tuple

import numpy as np
import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import SMEM_LIMIT, check_status, kernel_fn
from ccsd_tpu_torch.kernels.gcn import (
    adj_grad_plain,
    agg_group,
    check_bf16_size,
    check_cuda,
    check_cuda_f32,
    check_smem,
    check_strided,
    MAX_CLUSTER,
    _with_loop,
    gcn_degrees,
    gcn_norm,
    kernel_dtype,
    plain_in_f32,
    row_tiles,
    ticket_buffer,
)

# one block of the attention kernels holds a whole graph's channel
# (gmh_attention) or a graph's Q, K and N x N head sums (gmh_scores); above
# it, both take the tiled designs
MAX_N = 64
TILE = 32  # rows of a tile of the tiled designs (kTile, csrc/gmh_common.cuh)
TILED_MAX_GROUP = 4  # channels of a tile-pair score block (kMaxGroup, csrc/gmh_common.cuh)
H100_SMS = 132


def tile_pairs(N: int, tile: int = TILE) -> np.ndarray:
    """The plan of a tiled score launch: (I, J) of every pair of the
    ceil(N / tile) row tiles with I <= J, row-major, as int32 (pairs, 2).
    Block p takes pair p: the entries (n, m), n in tile I and m in tile J,
    and where I != J also (m, n); the last tile is ragged where tile does
    not divide N."""
    nt = -(-N // tile)
    return np.array([(i, j) for i in range(nt) for j in range(i, nt)], np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def pair_plan(N: int, device: torch.device) -> torch.Tensor:
    """``tile_pairs(N)`` on ``device``, made once per N and device."""
    return torch.from_numpy(tile_pairs(N)).to(device)


def channel_group(B: int, C: int, sms: int, fits: Callable[[int], bool]) -> int:
    """Channels per block G of a launch over B graphs (or graph tiles) x C
    channels.

    G starts at C, so that a graph's channels of one map entry leave as one
    run, and is halved while the grid of B x ceil(C / G) blocks leaves an
    SM without a block, or a block of G channels does not fit (``fits``).
    A block works on its channels together, so fewer, larger blocks write
    longer runs, down to one block an SM (the G sweep of
    scripts/gmh_stage_times.py)."""
    G = C
    while G > 1 and (B * -(-C // G) < sms or not fits(G)):
        G = (G + 1) // 2
    return G


@functools.lru_cache(maxsize=None)
def device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def tiled_scores_group(kernel: str, B: int, C: int, N: int, A: int,
                       sms: int = H100_SMS) -> int:
    """G of a tile-pair score launch of ``kernel``'s library (gmh_scores or
    gmh_attention), from the library's own count of a block's shared
    memory (which depends on attn only: any N is tiled; past
    TILED_MAX_GROUP channels the count exceeds the card's limit, as each
    warp stages its entries' values of every channel of the block): at
    grid's C = 8, two groups of four."""
    def smem(g: int) -> int:
        return kernel_fn(kernel, "gmh_tiled_scores_smem")(A, g)

    check_smem(kernel, smem(1), N=N, attn=A)
    return channel_group(B * len(tile_pairs(N)), C, sms, lambda g: smem(g) <= SMEM_LIMIT)


@functools.lru_cache(maxsize=None)
def projection_group(C: int, N: int, Fi: int, A: int, O: int) -> int:
    """G of a ``gmh_projection`` launch (blocks of one row tile of a graph):
    ``agg_group(C)``, halved while a block of G channels needs more shared
    memory than the card has (the library's own count).  A block holds the
    degrees of its channels' N rows: past what one channel's allow, raises
    a ``ValueError`` naming N, before any kernel is built."""
    dbytes = 4 * N
    if dbytes > SMEM_LIMIT:
        raise ValueError(f"gmh_attention: N={N}: the tiled design holds the degrees of a "
                         f"channel's N rows in one block ({dbytes} B > {SMEM_LIMIT} B of "
                         "shared memory)")

    def smem(g: int) -> int:
        return kernel_fn("gmh_attention", "gmh_projection_smem")(N, Fi, A, O, g)

    check_smem("gmh_attention", smem(1), N=N, F_in=Fi)
    G = agg_group(C)
    while G > 1 and smem(G) > SMEM_LIMIT:
        G //= 2
    return G


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


def gmh_projection_plain(x, adj, deg, wq, bq, wk, bk, wv, bv, loop: float = 1.0,
                         add_loop: bool = True):
    """The projection of the tiled design: x (B, N, F_in), adj (B, C, N,
    N), deg (B, C, N) the degrees ``gcn_degrees`` gives -> (qk (B, C, N,
    2 attn): Q | K, V (B, N, C * F_out))."""
    a = _with_loop(adj, loop) if add_loop else adj
    nx = (deg[..., :, None] * a * deg[..., None, :]) @ x[:, None]  # (B, C, N, F_in)
    w = torch.cat([wq, wk, wv], -1)
    b = torch.cat([torch.zeros(w.shape[0], t.shape[-1], dtype=w.dtype, device=w.device)
                   if bb is None else bb for bb, t in ((bq, wq), (bk, wk), (bv, wv))], -1)
    out = nx @ w[None] + b[None, :, None, :]
    A2 = 2 * wq.shape[-1]
    B, C, N, _ = out.shape
    return (out[..., :A2].contiguous(),
            out[..., A2:].permute(0, 2, 1, 3).reshape(B, N, C * wv.shape[-1]))


def gmh_projection(x, adj, deg, wq, bq, wk, bk, wv, bv, loop: float = 1.0,
                   add_loop: bool = True):
    """The projection launch of the tiled design (``csrc/gmh_attention.cu``
    ``gmh_projection_kernel``) for CUDA tensors, the plain version for CPU
    tensors; adj in any strides."""
    if x.device.type == "cpu":
        return gmh_projection_plain(x, adj, deg, wq, bq, wk, bk, wv, bv, loop, add_loop)
    check_cuda_f32("gmh_projection", x=x, deg=deg, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv)
    check_strided("gmh_projection", "adj", adj, x.device)
    B, C, N, Fi, A, O, _, _ = _check_shapes("gmh_projection", x, adj, wq, bq, wk, bk, wv, bv,
                                            1)
    if deg.shape != (B, C, N):
        raise ValueError(f"gmh_projection: deg {tuple(deg.shape)}, expected {(B, C, N)}")
    G = projection_group(C, N, Fi, A, O)
    qk = torch.empty((B, C, N, 2 * A), dtype=torch.float32, device=x.device)
    v_out = torch.empty((B, N, C * O), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gmh_attention", "gmh_projection_run")(
        x.data_ptr(), adj.data_ptr(), deg.data_ptr(), wq.data_ptr(), _ptr(bq), wk.data_ptr(),
        _ptr(bk), wv.data_ptr(), _ptr(bv), qk.data_ptr(), v_out.data_ptr(),
        B, C, N, Fi, A, O, G, *adj.stride(), int(add_loop), float(loop), stream,
    )
    check_status("gmh_projection", status)
    LAUNCHES["gmh_projection"] += 1
    return qk, v_out


def _check_shapes(name, x, adj, wq, bq, wk, bk, wv, bv, num_heads):
    """(B, C, N, F_in, attn, F_out, heads, head_dim), after checking every
    shape against x's and the weights'."""
    B, N, Fi = x.shape
    C, _, A = wq.shape
    O = wv.shape[-1]
    H, ds = head_split(A, num_heads)
    want = {"adj": (B, C, N, N), "wq": (C, Fi, A), "wk": (C, Fi, A),
            "wv": (C, Fi, O), "bq": (C, A), "bk": (C, A), "bv": (C, O)}
    got = {"adj": adj, "wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv}
    for k, shape in want.items():
        if got[k] is not None and tuple(got[k].shape) != shape:
            raise ValueError(f"{name}: {k} has shape "
                             f"{tuple(got[k].shape)}, expected {shape}")
    return B, C, N, Fi, A, O, H, ds


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_gmh_attention(x, adj, wq, bq, wk, bk, wv, bv, num_heads, out_dim, loop,
                          add_loop):
    dt = x.dtype
    check_cuda("gmh_attention", dt, x=x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv)
    check_strided("gmh_attention", "adj", adj, x.device, dt)
    B, C, N, Fi, A, O, H, ds = _check_shapes("gmh_attention", x, adj, wq, bq, wk, bk, wv,
                                             bv, num_heads)
    if dt == torch.bfloat16:
        check_bf16_size("gmh_attention", N)
    if N > MAX_N:
        return _launch_tiled(x, adj, wq, bq, wk, bk, wv, bv, H, ds, out_dim, loop, add_loop)
    attention_smem(N, Fi, A, O, H)
    v_out = torch.empty((B, N, C * O), dtype=dt, device=x.device)
    a_out = torch.empty((B, N, N, C), dtype=dt, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gmh_attention",
                       "gmh_attention_bf16" if dt == torch.bfloat16 else None)(
        x.data_ptr(), adj.data_ptr(), wq.data_ptr(), _ptr(bq), wk.data_ptr(),
        _ptr(bk), wv.data_ptr(), _ptr(bv), v_out.data_ptr(), a_out.data_ptr(),
        B, C, N, Fi, A, O, H, ds, *adj.stride(), math.sqrt(out_dim),
        int(add_loop), float(loop), stream,
    )
    check_status("gmh_attention", status)
    LAUNCHES["gmh_attention"] += 1
    return v_out, a_out


def _launch_tiled(x, adj, wq, bq, wk, bk, wv, bv, H, ds, out_dim, loop, add_loop):
    """N > MAX_N: the degrees, the projection, then the tile-pair scores."""
    B, N, _ = x.shape
    C, _, A = wq.shape
    G = tiled_scores_group("gmh_attention", B, C, N, A, device_sms(x.device))
    deg = gcn_degrees(adj, add_loop, loop)
    qk, v_out = gmh_projection(x, adj, deg, wq, bq, wk, bk, wv, bv, loop, add_loop)
    a_out = torch.empty((B, N, N, C), dtype=torch.float32, device=x.device)
    pairs = pair_plan(N, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gmh_attention", "gmh_tiled_scores_run")(
        qk.data_ptr(), qk[..., A:].data_ptr(), pairs.data_ptr(), a_out.data_ptr(),
        B, C, N, A, H, ds, G, pairs.shape[0], *qk.stride()[:3], *qk.stride()[:3],
        math.sqrt(out_dim), stream,
    )
    check_status("gmh_attention", status)
    LAUNCHES["gmh_attention"] += 1
    return v_out, a_out


class _GMHAttention(torch.autograd.Function):
    """The forward kernel, with ``gmh_attention_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, x, adj, wq, bq, wk, bk, wv, bv, num_heads, out_dim, loop, add_loop):
        ctx.save_for_backward(x, adj, wq, bq, wk, bk, wv, bv)
        ctx.args = (num_heads, out_dim, loop, add_loop)
        return _launch_gmh_attention(x, adj, wq, bq, wk, bk, wv, bv, num_heads, out_dim,
                                     loop, add_loop)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gv, ga):
        saved = ctx.saved_tensors
        need_x, need_adj = ctx.needs_input_grad[:2]
        grads = gmh_attention_bwd(*saved, gv, ga, *ctx.args, need_x=need_x,
                                  need_adj=need_adj)
        return (*grads, None, None, None, None)


def gmh_attention(x: torch.Tensor, adj: torch.Tensor, wq, bq, wk, bk, wv, bv,
                  num_heads: int, out_dim: int, loop: float = 1.0,
                  add_loop: bool = True):
    """GMH attention of all channels: the CUDA kernel for CUDA tensors (its
    backward a kernel too; bf16 tensors, N <= 64, the forward's bf16
    variant), the plain version for CPU tensors."""
    dt = kernel_dtype("gmh_attention", x=x, adj=adj, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv,
                      bv=bv)
    if x.device.type == "cpu":
        return plain_in_f32(gmh_attention_plain, dt, x, adj, wq, bq, wk, bk, wv, bv,
                            num_heads, out_dim, loop, add_loop)
    if dt != torch.bfloat16 and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, adj, wq, bq, wk, bk, wv, bv)):
        return _GMHAttention.apply(x, adj, wq, bq, wk, bk, wv, bv, num_heads, out_dim,
                                   loop, add_loop)
    return _launch_gmh_attention(x, adj, wq, bq, wk, bk, wv, bv, num_heads, out_dim, loop,
                                 add_loop)


# ------------------------------------------------------------------ backward


def gmh_attention_bwd_plain(x, adj, wq, bq, wk, bk, wv, bv, gv, ga, num_heads: int,
                            out_dim: int, loop: float = 1.0, add_loop: bool = True,
                            need_x: bool = True, need_adj: bool = True):
    """The gradients of ``gmh_attention_plain`` given gv = dL/dV (B, N,
    C * F_out) and ga = dL/dA (B, N, N, C), by hand: (dx or None, dadj or
    None, dwq, dbq, dwk, dbk, dwv, dbv), a bias's gradient None where the
    bias is."""
    norm = gcn_norm(adj, add_loop, loop)  # (B, C, N, N)
    nx = norm @ x[:, None]  # (B, C, N, F_in)

    def proj(w, b):
        out = nx @ w[None]
        return out if b is None else out + b[None, :, None, :]

    gqk = gmh_score_grad_plain(torch.cat([proj(wq, bq), proj(wk, bk)], -1), grad_sym_plain(ga),
                               num_heads, out_dim)
    return _grads_from_gqk(x, adj, norm, nx, wq, bq, wk, bk, wv, bv, gqk, gv, loop, add_loop,
                           need_x, need_adj)


def _grads_from_gqk(x, adj, norm, nx, wq, bq, wk, bk, wv, bv, gqk, gv, loop, add_loop,
                    need_x, need_adj):
    """Every gradient from gP = [gQ | gK | gV] (the row-tile kernel's
    share), as :func:`gmh_attention_bwd_plain` returns them."""
    B, N, Fi = x.shape
    C, _, A = wq.shape
    O = wv.shape[-1]
    gQ, gK = gqk[..., :A], gqk[..., A:]
    gV = gv.reshape(B, N, C, O).permute(0, 2, 1, 3)
    grads = []
    for gp, w, b in ((gQ, wq, bq), (gK, wk, bk), (gV, wv, bv)):
        grads += [torch.einsum("bcnf,bcnp->cfp", nx, gp),
                  None if b is None else gp.sum(dim=(0, 2))]
    gnx = gQ @ wq.transpose(1, 2) + gK @ wk.transpose(1, 2) + gV @ wv.transpose(1, 2)
    dx = (norm.transpose(-1, -2) @ gnx).sum(dim=1) if need_x else None
    dadj = adj_grad_plain(gnx @ x[:, None].transpose(-1, -2), adj, add_loop,
                          loop) if need_adj else None
    return (dx, dadj, *grads)


def grad_sym_plain(ga):
    """gM = (gA + gA^T) / 2 channel-major: ga = dL/dA (B, N, N, C) -> (B, C,
    N, N), the gradient of the map before its symmetrisation."""
    g = ga.permute(0, 3, 1, 2)
    return (g + g.transpose(-1, -2)) / 2


def gmh_score_grad_plain(qk, gm, num_heads: int, out_dim: int):
    """The score stage's gradient: qk (B, C, N, 2 attn), Q | K, and gm (B,
    C, N, >= N), the symmetrised dL/dA (its first N columns) -> (B, C, N,
    2 attn), gQ | gK, where A = sym(mean_h tanh(Q_h K_h^T / sqrt(out_dim)))."""
    B, C, N, A2 = qk.shape
    A = A2 // 2
    H, ds = head_split(A, num_heads)
    Qh = qk[..., :A].reshape(B, C, N, H, ds)
    Kh = qk[..., A:].reshape(B, C, N, H, ds)
    s = 1.0 / math.sqrt(out_dim)
    t = torch.tanh(torch.einsum("bcnhd,bcmhd->bchnm", Qh, Kh) * s)
    gS = gm[..., :N][:, :, None] * (1 - t * t) * (s / H)
    gQ = torch.einsum("bchnm,bcmhd->bcnhd", gS, Kh).reshape(B, C, N, A)
    gK = torch.einsum("bchnm,bcnhd->bcmhd", gS, Qh).reshape(B, C, N, A)
    return torch.cat([gQ, gK], -1)


# ------------------------------------------------------- above N = 64


MAX_SCORE_TILES = 16  # gmh_score_grad's cluster: every row tile of a graph


def map_row(N: int) -> int:
    """Row stride (floats) of the layout pass's outputs and of dA's
    channel-major scratch: rows on 128-byte lines."""
    return -(-N // 32) * 32


def gmh_bwd_layout_plain(adj, ga):
    """The layout pass: adj (B, C, N, N), ga = dL/dA (B, N, N, C) -> (ac,
    gm): gm = :func:`grad_sym_plain` (ga) and, where adj's rows are not
    unit-stride (a later layer's channels-last view), ac = adj, both
    contiguous (B, C, N, map_row(N)) with zeros past column N (ac None
    otherwise)."""
    B, C, N, _ = adj.shape

    def padded(t):
        out = t.new_zeros(B, C, N, map_row(N))
        out[..., :N] = t
        return out

    return (padded(adj) if adj.stride(-1) != 1 else None), padded(grad_sym_plain(ga))


def gmh_bwd_layout(adj, ga):
    """The layout pass of the tiled backward (``csrc/gmh_attention_bwd.cu``
    ``gmh_bwd_layout_kernel``, a thread per entry of a graph, all channels)
    for CUDA tensors, the plain version for CPU tensors; adj and ga in any
    strides.  adj is copied where its rows are not unit-stride: the
    row-tile kernel reads unit-stride rows."""
    if adj.device.type == "cpu":
        return gmh_bwd_layout_plain(adj, ga)
    for arg, t in (("adj", adj), ("ga", ga)):
        check_strided("gmh_bwd_layout", arg, t, adj.device)
    B, C, N, _ = adj.shape
    if ga.shape != (B, N, N, C):
        raise ValueError(f"gmh_bwd_layout: ga {tuple(ga.shape)}, expected {(B, N, N, C)}")
    new = functools.partial(torch.empty, (B, C, N, map_row(N)), dtype=torch.float32,
                            device=adj.device)
    gm, ac = new(), (new() if adj.stride(-1) != 1 else None)
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    status = kernel_fn("gmh_attention_bwd", "gmh_bwd_layout_run")(
        ga.data_ptr(), adj.data_ptr(), gm.data_ptr(), _ptr(ac), B, C, N, *ga.stride(),
        *adj.stride(), stream)
    check_status("gmh_bwd_layout", status)
    LAUNCHES["gmh_bwd_layout"] += 1
    return ac, gm


@functools.lru_cache(maxsize=None)
def score_grad_smem(A: int, H: int) -> int:
    """Shared bytes of a block of ``gmh_score_grad`` (any N up to
    MAX_SCORE_TILES row tiles); raises a ``ValueError`` where its design
    does not take attn A in H heads."""
    nbytes = kernel_fn("gmh_attention_bwd", "gmh_score_grad_smem")(A, H)
    if nbytes <= 0:
        raise ValueError(f"gmh_score_grad: attn={A} in {H} heads: the tiled design takes "
                         "head widths that are multiples of 4 and attn <= 32")
    check_smem("gmh_score_grad", nbytes, attn=A, heads=H)
    return nbytes


def gmh_score_grad(qk, gm, num_heads: int, out_dim: int):
    """gQ | gK of the tiled backward (``csrc/gmh_attention_bwd.cu``
    ``gmh_score_grad_kernel``, a cluster of row-tile blocks a graph and
    channel) for CUDA tensors, the plain version for CPU tensors; qk
    contiguous, gm the layout pass's (B, C, N, map_row(N))."""
    if qk.device.type == "cpu":
        return gmh_score_grad_plain(qk, gm, num_heads, out_dim)
    check_cuda_f32("gmh_score_grad", qk=qk, gm=gm)
    B, C, N, A2 = qk.shape
    H, ds = head_split(A2 // 2, num_heads)
    plan = score_plan(B, C, N, A2 // 2)
    if gm.shape != plan["map"]:
        raise ValueError(f"gmh_score_grad: gm {tuple(gm.shape)}, expected {plan['map']}")
    score_grad_smem(A2 // 2, H)
    gqk = torch.empty_like(qk)
    part_k = torch.empty(plan["part_k"], dtype=torch.float32, device=qk.device)
    stream = torch.cuda.current_stream(qk.device).cuda_stream
    status = kernel_fn("gmh_attention_bwd", "gmh_score_grad_run")(
        qk.data_ptr(), gm.data_ptr(), gqk.data_ptr(), part_k.data_ptr(), B, C, N, A2 // 2, H,
        ds, math.sqrt(out_dim), stream)
    check_status("gmh_score_grad", status)
    LAUNCHES["gmh_score_grad"] += 1
    return gqk


def score_tiles(N: int) -> int:
    """Row tiles of a graph, the blocks of a ``gmh_score_grad`` cluster;
    raises a ``ValueError`` naming N past MAX_SCORE_TILES."""
    nt = len(row_tiles(N))
    if nt > MAX_SCORE_TILES:
        raise ValueError(f"gmh_score_grad: N={N} needs {nt} row tiles in one cluster "
                         f"(at most {MAX_SCORE_TILES}: N <= {MAX_SCORE_TILES * TILE})")
    return nt


def score_plan(B: int, C: int, N: int, A: int) -> dict:
    """The host side of ``gmh_score_grad``, whose cluster holds every row
    tile of a (graph, channel) (:func:`score_tiles`; block I takes the
    tiles J = 0 .. nt - 1 in that order, and gK[J] sums the blocks'
    partials in the same order): ``map``, the shape of the layout pass's gm
    (rows of map_row(N) floats); ``part_k``, the partials' scratch, P(I, J)
    at [b, c, I, rows of J]."""
    return {"map": (B, C, N, map_row(N)), "part_k": (B, C, score_tiles(N), N, A)}


@functools.lru_cache(maxsize=None)
def row_tile_smem(N: int, Fi: int, A: int, O: int, need_adj: bool, need_x: bool) -> int:
    """Shared bytes of a block of the row-tile kernel (with what the call
    asks for), by the library's own count; raises a ``ValueError`` where the
    block does not fit or the design does not take the widths."""
    nbytes = kernel_fn("gmh_attention_bwd", "gmh_attention_bwd_tiled_smem")(
        N, Fi, A, O, int(need_x), int(need_adj))
    if nbytes <= 0:
        raise ValueError(f"gmh_attention_bwd: attn={A}, F_out={O}: the row-tile kernel "
                         "takes 2 attn + F_out <= 96, a multiple of 4")
    check_smem("gmh_attention_bwd", nbytes, N=N, F_in=Fi, attn=A, F_out=O)
    return nbytes


@functools.lru_cache(maxsize=None)
def attention_bwd_smem(N: int, Fi: int, A: int, O: int, H: int,
                       need_adj: bool = True, need_x: bool = True) -> int:
    """Shared bytes of one block of csrc/gmh_attention_bwd.cu: one (graph,
    channel) for N <= MAX_N, else one row tile of the row-tile kernel (the
    ``gmh_score_grad`` and ``gmh_projection`` blocks before it checked
    too), by the library's own counts; raises a ``ValueError`` naming N
    where a block does not fit or a design does not take the widths."""
    if N > MAX_N:
        score_grad_smem(A, H)
        score_tiles(N)
        projection_group(1, N, Fi, A, O)
        return row_tile_smem(N, Fi, A, O, need_adj, need_x)
    return fit_graph("gmh_attention_bwd", N,
                     lambda: kernel_fn("gmh_attention_bwd", "gmh_attention_bwd_smem")(
                         N, Fi, A, O, H))


def bwd_plan(B: int, C: int, N: int, Fi: int, A: int, O: int) -> dict:
    """The host side of the tiled ``gmh_attention_bwd`` (N > MAX_N):

    * ``tiles``: the row tiles (every kernel's products over all rows run
      in chunks of the same tiles; ``gmh_score_grad``'s own in
      :func:`score_plan`);
    * the row-tile kernel's clusters of MAX_CLUSTER blocks a channel (one
      block a row tile of a graph, the last cluster padded) and its
      scratch: dX's channel partials, a weight partial a cluster, and the
      tickets (MAX_CLUSTER a channel, one a graph's row tile)."""
    tiles = row_tiles(N)
    nt = len(tiles)
    clusters = -(-B * nt // MAX_CLUSTER)
    P = 2 * A + O
    return {"tiles": tiles, "clusters": clusters, "part_x": (B, C, N, Fi),
            "part_w": (clusters, C * (Fi * P + P)),
            "tickets": MAX_CLUSTER * C + B * nt}


def gmh_attention_bwd_tiled_plain(x, adj, wq, bq, wk, bk, wv, bv, gqk, gv, deg=None, ac=None,
                                  loop: float = 1.0, add_loop: bool = True,
                                  need_x: bool = True, need_adj: bool = True):
    """The row-tile kernel's share of the backward, from gqk = gQ | gK (B,
    C, N, 2 attn) and gv = dL/dV: every gradient, as
    :func:`gmh_attention_bwd_plain` returns them (deg and ac, the kernel's
    inputs from earlier launches, are not needed)."""
    norm = gcn_norm(adj, add_loop, loop)
    return _grads_from_gqk(x, adj, norm, norm @ x[:, None], wq, bq, wk, bk, wv, bv, gqk, gv,
                           loop, add_loop, need_x, need_adj)


def gmh_attention_bwd_tiled(x, adj, wq, bq, wk, bk, wv, bv, gqk, gv, deg=None, ac=None,
                            loop: float = 1.0, add_loop: bool = True, need_x: bool = True,
                            need_adj: bool = True):
    """The row-tile kernel of the tiled backward (``csrc/gmh_attention_bwd.cu``
    ``gmh_attention_bwd_tiled_kernel``) for CUDA tensors, the plain version
    for CPU tensors: every gradient from gqk (``gmh_score_grad``) and gv,
    with deg = ``gcn_degrees(adj)`` and ac the layout pass's copy of adj
    (None where adj's rows are unit-stride: the kernel reads adj itself);
    dadj in adj's layout."""
    if x.device.type == "cpu":
        return gmh_attention_bwd_tiled_plain(x, adj, wq, bq, wk, bk, wv, bv, gqk, gv, deg, ac,
                                             loop, add_loop, need_x, need_adj)
    gv = gv.contiguous()
    check_cuda_f32("gmh_attention_bwd_tiled", x=x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
                   gqk=gqk, gv=gv, deg=deg, ac=ac)
    check_strided("gmh_attention_bwd_tiled", "adj", adj, x.device)
    B, C, N, Fi, A, O, _, _ = _check_shapes("gmh_attention_bwd_tiled", x, adj, wq, bq, wk, bk,
                                            wv, bv, 1)
    a = adj if ac is None else ac
    if a.stride(-1) != 1 or deg is None or deg.shape != (B, C, N):
        raise ValueError("gmh_attention_bwd_tiled: needs deg (B, C, N) and an adjacency with "
                         "unit-stride rows (adj, or the layout pass's ac)")
    if gqk.shape != (B, C, N, 2 * A) or gv.shape != (B, N, C * O):
        raise ValueError(f"gmh_attention_bwd_tiled: gqk {tuple(gqk.shape)}, gv "
                         f"{tuple(gv.shape)}, expected {(B, C, N, 2 * A)}, {(B, N, C * O)}")
    row_tile_smem(N, Fi, A, O, need_adj, need_x)
    return _launch_row_tiles(x, adj, a, deg, wq, bq, wk, bk, wv, bv, gqk, gv, loop, add_loop,
                             need_x, need_adj)


def _launch_row_tiles(x, adj, a, deg, wq, bq, wk, bk, wv, bv, gqk, gv, loop, add_loop,
                      need_x, need_adj):
    """Launch the row-tile kernel on checked arguments (a: adj, or the
    layout pass's copy of it); dadj in adj's layout."""
    B, N, Fi = x.shape
    C, _, A = wq.shape
    O = wv.shape[-1]
    plan = bwd_plan(B, C, N, Fi, A, O)
    new = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    sizes = [C * Fi * A, C * Fi * A, C * Fi * O, C * A, C * A, C * O]
    out_w, part_w = new(sum(sizes)), new(plan["part_w"])
    dx, part_x = (new((B, N, Fi)), new(plan["part_x"])) if need_x else (None, None)
    dadj = torch.empty_like(adj) if need_adj else None  # adj's strides
    tickets = ticket_buffer(x.device, plan["tickets"])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gmh_attention_bwd", "gmh_attention_bwd_tiled_run")(
        x.data_ptr(), a.data_ptr(), deg.data_ptr(), wq.data_ptr(), wk.data_ptr(),
        wv.data_ptr(), gqk.data_ptr(), gv.data_ptr(), _ptr(dx), _ptr(dadj), _ptr(part_x),
        part_w.data_ptr(), out_w.data_ptr(), tickets.data_ptr(), B, C, N, Fi, A, O,
        plan["clusters"], *a.stride()[:3], *(dadj.stride() if need_adj else (0,) * 4),
        int(add_loop), float(loop), stream,
    )
    check_status("gmh_attention_bwd_tiled", status)
    LAUNCHES["gmh_attention_bwd_tiled"] += 1
    return _split_weight_grads(dx, dadj, out_w, sizes, bq, bk, bv, C, Fi, A, O)


def _gmh_attention_bwd_tiled(x, adj, wq, bq, wk, bk, wv, bv, gv, ga, H, out_dim, loop,
                             add_loop, need_x, need_adj):
    """N > MAX_N: the degrees, Q and K recomputed, the layout pass, gQ |
    gK, then every gradient by row tiles (the arguments checked by the
    caller and, for every launch, by :func:`attention_bwd_smem`)."""
    N, Fi = x.shape[1:]
    A, O = wq.shape[-1], wv.shape[-1]
    attention_bwd_smem(N, Fi, A, O, H, need_adj, need_x)
    deg = gcn_degrees(adj, add_loop, loop)
    qk, _ = gmh_projection(x, adj, deg, wq, bq, wk, bk, wv, bv, loop, add_loop)
    ac, gm = gmh_bwd_layout(adj, ga)
    gqk = gmh_score_grad(qk, gm, H, out_dim)
    del qk, gm
    return _launch_row_tiles(x, adj, adj if ac is None else ac, deg, wq, bq, wk, bk, wv, bv,
                             gqk, gv, loop, add_loop, need_x, need_adj)


def gmh_attention_bwd(x, adj, wq, bq, wk, bk, wv, bv, gv, ga, num_heads: int,
                      out_dim: int, loop: float = 1.0, add_loop: bool = True,
                      need_x: bool = True, need_adj: bool = True):
    """Backward of ``gmh_attention``: the CUDA kernel for CUDA tensors (five
    launches above N = 64, the module's docstring says which), the plain
    backward for CPU tensors; returns as :func:`gmh_attention_bwd_plain`.
    adj and ga are read through their strides; dadj comes in adj's
    layout."""
    if x.device.type == "cpu":
        return gmh_attention_bwd_plain(x, adj, wq, bq, wk, bk, wv, bv, gv, ga, num_heads,
                                       out_dim, loop, add_loop, need_x, need_adj)
    gv = gv.contiguous()
    check_cuda_f32("gmh_attention_bwd", x=x, wq=wq, bq=bq, wk=wk, bk=bk, wv=wv, bv=bv,
                   gv=gv)
    for arg, t in (("adj", adj), ("ga", ga)):
        check_strided("gmh_attention_bwd", arg, t, x.device)
    B, C, N, Fi, A, O, H, ds = _check_shapes("gmh_attention_bwd", x, adj, wq, bq, wk, bk,
                                             wv, bv, num_heads)
    if gv.shape != (B, N, C * O) or ga.shape != (B, N, N, C):
        raise ValueError(f"gmh_attention_bwd: gv {tuple(gv.shape)}, ga {tuple(ga.shape)} "
                         f"do not match the outputs ({B}, {N}, {C * O}), ({B}, {N}, {N}, {C})")
    if N > MAX_N:
        return _gmh_attention_bwd_tiled(x, adj, wq, bq, wk, bk, wv, bv, gv, ga, H, out_dim,
                                        loop, add_loop, need_x, need_adj)
    attention_bwd_smem(N, Fi, A, O, H)
    new = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    sizes = [C * Fi * A, C * Fi * A, C * Fi * O, C * A, C * A, C * O]
    clusters = kernel_fn("gmh_attention_bwd", "gmh_attention_bwd_clusters")(B)
    out_w, part_w = new(sum(sizes)), new((clusters, sum(sizes)))  # a partial a cluster
    dx, part_x = (new((B, N, Fi)), new((B, C, N, Fi))) if need_x else (None, None)
    dadj = torch.empty_like(adj) if need_adj else None  # adj's strides
    tickets = ticket_buffer(x.device, MAX_CLUSTER * C + B)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gmh_attention_bwd")(
        x.data_ptr(), adj.data_ptr(), wq.data_ptr(), _ptr(bq), wk.data_ptr(), _ptr(bk),
        wv.data_ptr(), _ptr(bv), gv.data_ptr(), ga.data_ptr(), _ptr(dx), _ptr(dadj),
        _ptr(part_x), part_w.data_ptr(), out_w.data_ptr(), tickets.data_ptr(), B, C, N, Fi,
        A, O, H, ds,
        *adj.stride(), *ga.stride(), *(dadj.stride() if need_adj else (0,) * 4),
        math.sqrt(out_dim), int(add_loop), float(loop), stream,
    )
    check_status("gmh_attention_bwd", status)
    LAUNCHES["gmh_attention_bwd"] += 1
    return _split_weight_grads(dx, dadj, out_w, sizes, bq, bk, bv, C, Fi, A, O)


def _split_weight_grads(dx, dadj, out_w, sizes, bq, bk, bv, C, Fi, A, O):
    """The backward's outputs as :func:`gmh_attention_bwd_plain` returns
    them, from out_w (dWq, dWk, dWv, dbq, dbk, dbv one after another)."""
    dwq, dwk, dwv, dbq, dbk, dbv = out_w.split(sizes)
    return (dx, dadj, dwq.view(C, Fi, A), None if bq is None else dbq.view(C, A),
            dwk.view(C, Fi, A), None if bk is None else dbk.view(C, A),
            dwv.view(C, Fi, O), None if bv is None else dbv.view(C, O))
