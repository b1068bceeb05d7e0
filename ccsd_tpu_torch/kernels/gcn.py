"""Degree-normalised GCN aggregation: CUDA kernels (forward and backward),
plain versions, wrappers.

Replaces ``gcn_aggregate_pallas`` (ccsd_tpu/ops/pallas/gcn.py:45-85, body
``_gcn_kernel`` :31-42).  Per graph b:

    A'  = A with the diagonal set to ``loop`` (1.0, or 2.0 when improved)
    d   = max(rowsum A', 1)^-1/2
    out = (d ⊙ A' ⊙ d^T) (X W) + bias

The kernel is ``csrc/gcn_aggregate.cu``.  With ``add_loop=False`` the
diagonal is kept as given, as ``gcn_norm`` does.

A block of ``csrc/gcn_aggregate.cu`` or ``csrc/channel_agg.cu`` holds a
whole graph where N <= ``WHOLE_GRAPH_N`` and sums its degrees itself.  A
larger graph (grid: N = 361) is cut into row tiles (``gcn_aggregate``:
``row_tiles(N, rows)`` of ``gcn_aggregate_plan``, at most ``MAX_ROW_TILES``
tiles of at most ``ROW_TILE`` rows where they fit; ``channel_agg`` and the attention's
``gmh_projection`` take the normalised aggregation tile of
``csrc/agg_tile.cuh``, blocks of ``AGG_ROWS`` rows and ``agg_group``
channels), and ``gcn_degrees`` (``csrc/gcn_degrees.cu``, one more launch
with a count of its own) first computes d once per row for them to read.

On a CUDA tensor that needs a gradient the wrapper runs the forward kernel
inside a ``torch.autograd.Function`` whose backward is the kernel
``csrc/gcn_aggregate_bwd.cu`` (a graph's rows over a few blocks, N <= 64;
one launch, its batch sums ordered by the tickets of ``ticket_buffer``;
above N = 64 the file's row-tile kernel over the ``gcn_bwd_plan``, on the
degrees the forward's ``gcn_degrees`` launch computed), with
``gcn_aggregate_bwd_plain`` beside it: the
gradients of x, adj, the weight and the bias written out by hand
(``csrc/grad_common.cuh`` gives the formulas).  The degree clamp follows
``jnp.clip``: at a row sum of exactly 1 (a node with only its loop) half
the gradient passes, as ``jax.grad`` of the reference gives, in the
kernel, in the plain backward and in autograd of the plain forward
(``torch.maximum`` splits a tie the same way).

The forward kernels of this module and of ``channel_agg``, ``gmh_attention``
and ``gmh_scores`` also take bf16 tensors (all of a call; ``kernel_dtype``
raises on a mix) up to N = 64, for the bf16 score networks: the same
templated kernels through their ``*_bf16*`` C entry points, the inputs
widened to f32 as they are staged and each output rounded to bf16 once.
``plain_in_f32`` is their plain version and ``bf16_kernel_tol`` the gate
the tests and the smoke hold them to; a bf16 call above N = 64 raises
(``check_bf16_size``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.build import SMEM_LIMIT, check_status, kernel_fn

WHOLE_GRAPH_N = 64  # up to this N a block holds all rows of a graph
ROW_TILE = 32       # rows per block of a larger graph (channel_agg's rows argument, the
                    # tiled backwards; at most, gcn_aggregate's row tiles)
MAX_ROW_TILES = 16  # gcn_aggregate's row tiles of a graph, while they have at most ROW_TILE rows
AGG_ROWS = 16       # rows of a block of the aggregation tile (agg::kRows)
AGG_MAX_GROUP = 8   # channels of a block of the aggregation tile (agg::kMaxGroup)


def agg_group(C: int) -> int:
    """Channels G of a block of the normalised aggregation tile over C
    channels: 8 or 4 where they divide C (a channels-last adjacency then
    arrives four channels a 16-byte copy, and at G = C = 8 a block reads
    each 32-byte sector of its rows once), else the least G <= 8 that
    splits C into equal groups, the last one short by less than a group."""
    for G in (AGG_MAX_GROUP, 4):
        if C % G == 0:
            return G
    return -(-C // -(-C // AGG_MAX_GROUP))


def is_tiled(N: int) -> bool:
    """Whether the normalising kernels cut a graph of N nodes into row
    tiles, which read the degrees of a ``gcn_degrees`` launch before them."""
    return N > WHOLE_GRAPH_N


def rows_per_block(N: int) -> int:
    """Rows of a graph-channel that ``channel_agg`` is told a block takes:
    the whole graph up to WHOLE_GRAPH_N, else ROW_TILE (the kernel then
    takes the aggregation tile, after a ``gcn_degrees`` launch)."""
    return ROW_TILE if is_tiled(N) else N


def gcn_rows(N: int) -> int:
    """Rows of a block of ``gcn_aggregate`` as planned by N: the whole graph
    up to WHOLE_GRAPH_N, else min(ROW_TILE, ceil(N / MAX_ROW_TILES)) (at
    N = 361, 16 tiles of 23 rows: grid's 8 graphs make 128 blocks on the
    H100's 132 SMs; the tiles are ``row_tiles(N, rows)``).
    ``gcn_aggregate_plan`` takes fewer where a block would not fit."""
    return min(ROW_TILE, -(-N // MAX_ROW_TILES)) if is_tiled(N) else N


def _with_loop(adj: torch.Tensor, loop: float) -> torch.Tensor:
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    return adj * (1.0 - eye) + loop * eye


def gcn_degrees_plain(adj: torch.Tensor, add_loop: bool = True,
                      loop: float = 1.0) -> torch.Tensor:
    """(..., N, N) -> d (..., N) = max(rowsum A', 1)^-1/2.  ``torch.maximum``
    passes half the gradient at a tie, as ``jnp.clip`` does (``clamp``
    would pass all of it)."""
    if add_loop:
        adj = _with_loop(adj, loop)
    return torch.maximum(adj.sum(dim=-1), adj.new_ones(())).pow(-0.5)


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


# raised where a kernel's input needs a gradient that no backward kernel gives
NO_BACKWARD = ("the kernel has no backward yet (gcn_aggregate and gmh_attention have "
               "backward kernels; channel_agg, gmh_scores and gcn_degrees do not, so "
               "model.fused cannot train)")


# the element types of the forward kernels' bf16 variants: every tensor of a
# call is float32, or every one bfloat16 (a whole graph a block only)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_dtype(name: str, **tensors: Optional[torch.Tensor]) -> torch.dtype:
    """The one dtype of a kernel call's tensors; raises a ``TypeError``
    naming the arguments where they mix.  (The kernels take float32 or
    bfloat16, ``check_cuda``; the plain versions any float dtype.)"""
    got = {arg: t.dtype for arg, t in tensors.items() if t is not None}
    if len(set(got.values())) > 1:
        mix = ", ".join(f"{arg} {dt}" for arg, dt in got.items())
        raise TypeError(f"{name}: mixed dtypes ({mix}): every tensor of a call must be "
                        "float32, or every one bfloat16")
    return next(iter(got.values()))


def check_bf16_size(name: str, N: int) -> None:
    """Raise where a bf16 call needs a tiled design, which takes float32
    only."""
    if is_tiled(N):
        raise NotImplementedError(f"{name}: bf16 above N = {WHOLE_GRAPH_N} is not ported "
                                  f"(N={N}): the tiled designs take float32")


def plain_in_f32(fn, dtype: torch.dtype, *args, **kwargs):
    """The plain version of a kernel for tensors of ``dtype``: for bf16,
    ``fn`` (a float32 function) on the tensors of ``args`` upcast to
    float32, each output rounded to bf16, as the bf16 kernels round theirs
    once; for another dtype, ``fn`` as it is."""
    if dtype != torch.bfloat16:
        return fn(*args, **kwargs)
    out = fn(*(a.float() if isinstance(a, torch.Tensor) else a for a in args), **kwargs)
    return tuple(o.to(dtype) for o in out) if isinstance(out, tuple) else out.to(dtype)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at each |t| (8 significant bits), as f32."""
    a = t.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bf16_kernel_tol(ref: torch.Tensor) -> dict:
    """The gate of a bf16 kernel against its plain version
    (``plain_in_f32``), element by element: one bf16 ulp of the plain
    entry plus 1e-5 of the output's scale (its largest |entry|).  Both
    round an f32 value to bf16 once, and those f32 values differ only in
    the order of their f32 sums, so the two may round to neighbouring
    bf16 values."""
    return dict(rtol=0.0, atol=bf16_ulp(ref) + 1e-5 * ref.float().abs().max())


def check_cuda(name: str, dtype: torch.dtype, dense_rows: bool = False,
               **tensors: Optional[torch.Tensor]) -> None:
    """The checks every kernel wrapper makes before a launch: CUDA tensors
    on one device, all of ``dtype``.  With ``dense_rows`` a tensor need
    only have a unit stride in its last dimension (the kernel takes the
    other strides).  A tensor that needs a gradient raises: the wrappers
    with a backward kernel launch their forward where autograd does not
    record."""
    dev = None
    for arg, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on {dev}")
        dev = t.device
        if t.dtype != dtype or dtype not in KERNEL_DTYPES:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype} "
                            "(float32 or bfloat16)")
        if not (t.stride(-1) == 1 if dense_rows else t.is_contiguous()):
            raise ValueError(f"{name}: {arg} is not "
                             + ("dense in its last dimension" if dense_rows else "contiguous"))
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(f"{name}: {arg} needs a gradient: {NO_BACKWARD}")


def check_cuda_f32(name: str, dense_rows: bool = False,
                   **tensors: Optional[torch.Tensor]) -> None:
    """``check_cuda`` of float32 tensors (every backward kernel's)."""
    check_cuda(name, torch.float32, dense_rows, **tensors)


def check_strided(name: str, arg: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype = torch.float32) -> None:
    """The checks of a tensor the kernel reads through its strides."""
    if t.device != device or t.device.type != "cuda" or t.dtype != dtype:
        raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {device}")
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(f"{name}: {arg} needs a gradient: {NO_BACKWARD}")


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
    check_strided("gcn_degrees", "adj", adj, adj.device)
    B, C, N, _ = adj.shape
    deg = torch.empty((B, C, N), dtype=torch.float32, device=adj.device)
    stream = torch.cuda.current_stream(adj.device).cuda_stream
    status = kernel_fn("gcn_degrees")(adj.data_ptr(), deg.data_ptr(), B, C, N,
                                      *adj.stride(), int(add_loop), float(loop), stream)
    check_status("gcn_degrees", status)
    LAUNCHES["gcn_degrees"] += 1
    return deg


@functools.lru_cache(maxsize=None)
def gcn_aggregate_plan(N: int, Fi: int, Fo: int) -> Tuple[int, int]:
    """(rows, shared bytes) of a block of csrc/gcn_aggregate.cu: ``gcn_rows(N)``
    rows, or where a row tile's block would exceed the card's limit, the
    most rows below that fit (by the library's own count: the layout lives
    in the CUDA source); raises where even one row does not fit."""
    smem = kernel_fn("gcn_aggregate", "gcn_aggregate_smem")
    rows = gcn_rows(N)
    nbytes = smem(N, Fi, Fo, rows)
    while is_tiled(N) and rows > 1 and nbytes > SMEM_LIMIT:
        rows -= 1
        nbytes = smem(N, Fi, Fo, rows)
    check_smem("gcn_aggregate", nbytes, N=N, F_in=Fi, F_out=Fo)
    return rows, nbytes


def gcn_aggregate_smem(N: int, Fi: int, Fo: int) -> int:
    """Shared bytes of a block of csrc/gcn_aggregate.cu as planned; raises
    where it exceeds the card's limit."""
    return gcn_aggregate_plan(N, Fi, Fo)[1]


def _launch_gcn_aggregate(x, adj, weight, bias, loop, add_loop):
    """-> (out, the degrees (B, N) where the row tiles read them, else None);
    bf16 tensors take the whole-graph kernel's bf16 variant."""
    dt = x.dtype
    check_cuda("gcn_aggregate", dt, x=x, adj=adj, weight=weight, bias=bias)
    B, N, Fi = x.shape
    Fo = weight.shape[1]
    if adj.shape != (B, N, N) or weight.shape != (Fi, Fo) or (
        bias is not None and bias.shape != (Fo,)
    ):
        raise ValueError(
            f"gcn_aggregate: shapes x {tuple(x.shape)}, adj {tuple(adj.shape)}, "
            f"weight {tuple(weight.shape)} do not agree"
        )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if dt == torch.bfloat16:
        check_bf16_size("gcn_aggregate", N)
        gcn_aggregate_plan(N, Fi, Fo)
        out = torch.empty((B, N, Fo), dtype=dt, device=x.device)
        status = kernel_fn("gcn_aggregate", "gcn_aggregate_bf16_run")(
            x.data_ptr(), adj.data_ptr(), weight.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), B, N, Fi, Fo,
            int(add_loop), float(loop), stream)
        check_status("gcn_aggregate", status)
        LAUNCHES["gcn_aggregate"] += 1
        return out, None
    rows = gcn_aggregate_plan(N, Fi, Fo)[0]
    deg = gcn_degrees(adj[:, None], add_loop, loop) if rows < N else None
    out = torch.empty((B, N, Fo), dtype=torch.float32, device=x.device)
    status = kernel_fn("gcn_aggregate")(
        x.data_ptr(), adj.data_ptr(), 0 if deg is None else deg.data_ptr(),
        weight.data_ptr(), 0 if bias is None else bias.data_ptr(), out.data_ptr(),
        B, N, Fi, Fo, rows, int(add_loop), float(loop), stream,
    )
    check_status("gcn_aggregate", status)
    LAUNCHES["gcn_aggregate"] += 1
    return out, None if deg is None else deg[:, 0]


class _GCNAggregate(torch.autograd.Function):
    """The forward kernel, with ``gcn_aggregate_bwd`` as its backward; above
    N = 64 the backward reads the degrees the forward's launch computed."""

    @staticmethod
    def forward(ctx, x, adj, weight, bias, loop, add_loop):
        out, deg = _launch_gcn_aggregate(x, adj, weight, bias, loop, add_loop)
        ctx.save_for_backward(x, adj, weight, deg)
        ctx.loop, ctx.add_loop, ctx.has_bias = loop, add_loop, bias is not None
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, adj, weight, deg = ctx.saved_tensors
        need_x, need_adj = ctx.needs_input_grad[:2]
        dx, dadj, dw, db = gcn_aggregate_bwd(x, adj, weight, g.contiguous(), ctx.loop,
                                             ctx.add_loop, need_x, need_adj, deg=deg)
        return dx, dadj, dw, db if ctx.has_bias else None, None, None


def gcn_aggregate(x: torch.Tensor, adj: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, loop: float = 1.0,
                  add_loop: bool = True) -> torch.Tensor:
    """GCN aggregation: the CUDA kernel for CUDA tensors (its backward a
    kernel too; bf16 tensors, N <= 64, the forward's bf16 variant), the
    plain version for CPU tensors."""
    dt = kernel_dtype("gcn_aggregate", x=x, adj=adj, weight=weight, bias=bias)
    if x.device.type == "cpu":
        return plain_in_f32(gcn_aggregate_plain, dt, x, adj, weight, bias, loop, add_loop)
    if dt == torch.bfloat16:
        return _launch_gcn_aggregate(x, adj, weight, bias, loop, add_loop)[0]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, adj, weight, bias)):
        return _GCNAggregate.apply(x, adj, weight, bias, loop, add_loop)
    return _launch_gcn_aggregate(x, adj, weight, bias, loop, add_loop)[0]


# ------------------------------------------------------------------ backward


def degree_slope(r: torch.Tensor) -> torch.Tensor:
    """d(max(r, 1)^-1/2)/dr with ``jnp.clip``'s rule at the tie: -r^-3/2 / 2
    above 1, -1/4 at 1, 0 below."""
    return torch.where(r > 1, -0.5 * r.clamp(min=1.0).pow(-1.5),
                       torch.where(r == 1, -0.25, 0.0).to(r.dtype))


def adj_grad_plain(gN: torch.Tensor, adj: torch.Tensor, add_loop: bool = True,
                   loop: float = 1.0) -> torch.Tensor:
    """dL/dadj from gN = dL/dnorm, norm = gcn_norm(adj), (..., N, N), by
    hand: the direct term gN d_n d_m, and each row's degree term
    slope_n sum_m (gN A' + (gN A')^T)[n, m] d_m; an assigned diagonal gets
    nothing."""
    a = _with_loop(adj, loop) if add_loop else adj
    r = a.sum(dim=-1)
    d = torch.maximum(r, r.new_ones(())).pow(-0.5)
    ga = gN * a
    dr = degree_slope(r) * ((ga + ga.transpose(-1, -2)) @ d[..., None])[..., 0]
    out = gN * d[..., :, None] * d[..., None, :] + dr[..., :, None]
    if add_loop:
        out = out * (1.0 - torch.eye(a.shape[-1], dtype=a.dtype, device=a.device))
    return out


def gcn_aggregate_bwd_plain(x, adj, weight, g, loop: float = 1.0, add_loop: bool = True,
                            need_x: bool = True, need_adj: bool = True):
    """The gradients of ``gcn_aggregate_plain`` given g = dL/dout (B, N,
    F_out), by hand: (dx or None, dadj or None, dweight, dbias)."""
    norm = gcn_norm(adj, add_loop, loop)
    dY = norm.transpose(-1, -2) @ g
    dx = dY @ weight.T if need_x else None
    dadj = adj_grad_plain(g @ (x @ weight).transpose(-1, -2), adj, add_loop,
                          loop) if need_adj else None
    return dx, dadj, torch.einsum("bnf,bno->fo", x, dY), g.sum(dim=(0, 1))


TICKETS = 1 << 16  # ints of a device's ticket buffer
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def ticket_buffer(device: torch.device, need: int) -> torch.Tensor:
    """The int32 tickets that order the backward kernels' sums over blocks
    (csrc/grad_common.cuh) on ``device``: zeros, allocated on first use and
    left zero by every launch, so launches that use it must not run
    concurrently on two streams.  Raises where a launch needs more than it
    holds, or where the first use is inside a CUDA-graph capture."""
    if need > TICKETS:
        raise ValueError(f"the backward kernels' sums need {need} tickets (limit {TICKETS})")
    buf = _TICKETS.get(device)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the backward kernels' tickets are allocated at their first "
                               "launch, which must not be inside a CUDA-graph capture")
        buf = _TICKETS[device] = torch.zeros(TICKETS, dtype=torch.int32, device=device)
    return buf


MAX_CLUSTER = 8  # blocks of a backward kernel's cluster, at most
BWD_GROUP = 8    # tile partials the tiled gcn_aggregate_bwd sums together (csrc kGroup)


@functools.lru_cache(maxsize=None)
def gcn_aggregate_bwd_clusters(B: int, N: int) -> int:
    """Clusters of one csrc/gcn_aggregate_bwd.cu launch, each with a
    weight partial of its own in the scratch."""
    return kernel_fn("gcn_aggregate_bwd", "gcn_aggregate_bwd_clusters")(B, N)


@functools.lru_cache(maxsize=None)
def gcn_bwd_geometry(N: int, Fi: int, Fo: int, need_adj: bool) -> Tuple[int, int, int]:
    """(rows of a row tile, chunks a pass, shared bytes) of a block of the
    tiled gcn_aggregate_bwd (N > 64): row tiles of gcn_aggregate's
    ``gcn_rows(N)`` rows (at N = 361, 16 tiles of 23 rows: grid's 8 graphs
    make 128 blocks on the H100's 132 SMs), every ROW_TILE-row chunk of V's
    sum in one pass; where the block would not fit the card, fewer chunks
    a pass (two passes' buffers then), down to one, then fewer rows, by the
    library's own count; raises a ``ValueError`` naming N where one row
    and one chunk do not fit."""
    smem = kernel_fn("gcn_aggregate_bwd", "gcn_aggregate_bwd_tiled_smem")
    rows, pc = gcn_rows(N), -(-N // ROW_TILE)
    nbytes = smem(N, Fi, Fo, rows, pc, int(need_adj))
    while nbytes > SMEM_LIMIT and (pc > 1 or rows > 1):
        if pc > 1:
            pc -= 1
        else:
            rows -= 1
        nbytes = smem(N, Fi, Fo, rows, pc, int(need_adj))
    check_smem("gcn_aggregate_bwd", nbytes, N=N, F_in=Fi, F_out=Fo)
    return rows, pc, nbytes


@functools.lru_cache(maxsize=None)
def gcn_aggregate_bwd_smem(N: int, Fi: int, Fo: int, need_adj: bool = True) -> int:
    """Shared bytes of a block of csrc/gcn_aggregate_bwd.cu: one row group
    of a graph (N <= 64) or, above, one row tile (with dA or without), by
    the library's own count; raises a ``ValueError`` naming N where it
    exceeds the card's limit."""
    if is_tiled(N):
        return gcn_bwd_geometry(N, Fi, Fo, need_adj)[2]
    nbytes = kernel_fn("gcn_aggregate_bwd", "gcn_aggregate_bwd_smem")(N, Fi, Fo)
    check_smem("gcn_aggregate_bwd", nbytes, N=N, F_in=Fi, F_out=Fo)
    return nbytes


def row_tiles(N: int, rows: int = ROW_TILE) -> List[Tuple[int, int]]:
    """(first row, rows) of each row tile of a graph: `rows` rows each, the
    last ragged; ROW_TILE in the tiled attention backward (N > 64), whose
    chunks of their products over all rows are the same tiles."""
    return [(r0, min(rows, N - r0)) for r0 in range(0, N, rows)]


def gcn_bwd_plan(B: int, N: int, Fi: int, Fo: int, rows: Optional[int] = None,
                 pc: Optional[int] = None) -> Dict[str, object]:
    """The host side of the tiled ``gcn_aggregate_bwd`` (N > 64): its row
    tiles of ``rows`` rows (by default ``gcn_rows(N)``, as
    ``gcn_bwd_geometry`` starts), a block each; the ROW_TILE-row chunks of
    V's sum over rows, which every block takes in passes of ``pc`` chunks
    (by default all), in chunk order (``passes``: (first chunk, chunks));
    the groups of BWD_GROUP tiles whose partials are summed together; the
    scratch it allocates (a weight partial a tile, then one a group) and
    its tickets (one a group, then one)."""
    rows = gcn_rows(N) if rows is None else rows
    tiles, chunks = row_tiles(N, rows), row_tiles(N)
    pc = len(chunks) if pc is None else pc
    groups = -(-B * len(tiles) // BWD_GROUP)
    return {"tiles": tiles, "rows": rows, "chunks": chunks, "pass": pc,
            "passes": [(k, min(pc, len(chunks) - k)) for k in range(0, len(chunks), pc)],
            "groups": groups, "part": (B * len(tiles) + groups, Fi * Fo + Fo),
            "tickets": groups + 1}


def _gcn_aggregate_bwd_tiled(x, adj, weight, g, loop, add_loop, need_x, need_adj, deg):
    """N > 64: the row-tile kernel, on the given degrees or, where none are
    given, after a gcn_degrees launch."""
    B, N, Fi = x.shape
    Fo = weight.shape[1]
    plan = gcn_bwd_plan(B, N, Fi, Fo, *gcn_bwd_geometry(N, Fi, Fo, need_adj)[:2])
    if deg is None:
        deg = gcn_degrees(adj[:, None], add_loop, loop)
    elif deg.numel() != B * N or not deg.is_contiguous():
        raise ValueError(f"gcn_aggregate_bwd: deg {tuple(deg.shape)} is not the contiguous "
                         f"degrees of {B} graphs of {N} nodes")
    check_cuda_f32("gcn_aggregate_bwd", x=x, deg=deg)
    new = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    dx = new((B, N, Fi)) if need_x else None
    dadj = new((B, N, N)) if need_adj else None
    out_w, part = new(Fi * Fo + Fo), new(plan["part"])
    tickets = ticket_buffer(x.device, plan["tickets"])
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gcn_aggregate_bwd", "gcn_aggregate_bwd_tiled_run")(
        x.data_ptr(), adj.data_ptr(), deg.data_ptr(), weight.data_ptr(), g.data_ptr(), ptr(dx),
        ptr(dadj), part.data_ptr(), out_w.data_ptr(), tickets.data_ptr(), B, N, Fi, Fo,
        plan["rows"], plan["pass"], int(add_loop), float(loop), stream)
    check_status(f"gcn_aggregate_bwd (N={N})", status)
    LAUNCHES["gcn_aggregate_bwd"] += 1
    return dx, dadj, out_w[:Fi * Fo].view(Fi, Fo), out_w[Fi * Fo:]


def gcn_aggregate_bwd(x, adj, weight, g, loop: float = 1.0, add_loop: bool = True,
                      need_x: bool = True, need_adj: bool = True,
                      deg: Optional[torch.Tensor] = None):
    """Backward of ``gcn_aggregate``: the CUDA kernel for CUDA tensors (a
    row-tile design above N = 64, which reads ``deg``, the degrees (B, N)
    of adj, or launches ``gcn_degrees`` for them where none are given), the
    plain backward for CPU tensors -> (dx or None, dadj or None, dweight,
    dbias)."""
    if x.device.type == "cpu":
        return gcn_aggregate_bwd_plain(x, adj, weight, g, loop, add_loop, need_x, need_adj)
    check_cuda_f32("gcn_aggregate_bwd", x=x, adj=adj, weight=weight, g=g)
    B, N, Fi = x.shape
    Fo = weight.shape[1]
    if adj.shape != (B, N, N) or weight.shape != (Fi, Fo) or g.shape != (B, N, Fo):
        raise ValueError(
            f"gcn_aggregate_bwd: shapes x {tuple(x.shape)}, adj {tuple(adj.shape)}, "
            f"weight {tuple(weight.shape)}, g {tuple(g.shape)} do not agree")
    if is_tiled(N):
        return _gcn_aggregate_bwd_tiled(x, adj, weight, g, loop, add_loop, need_x, need_adj,
                                        deg)
    gcn_aggregate_bwd_smem(N, Fi, Fo)
    new = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    dx = new((B, N, Fi)) if need_x else None
    dadj = new((B, N, N)) if need_adj else None
    out_w = new(Fi * Fo + Fo)
    part = new((gcn_aggregate_bwd_clusters(B, N), Fi * Fo + Fo))
    tickets = ticket_buffer(x.device, MAX_CLUSTER)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernel_fn("gcn_aggregate_bwd")(
        x.data_ptr(), adj.data_ptr(), weight.data_ptr(), g.data_ptr(), ptr(dx), ptr(dadj),
        part.data_ptr(), out_w.data_ptr(), tickets.data_ptr(), B, N, Fi, Fo, int(add_loop),
        float(loop), stream)
    check_status("gcn_aggregate_bwd", status)
    LAUNCHES["gcn_aggregate_bwd"] += 1
    return dx, dadj, out_w[:Fi * Fo].view(Fi, Fo), out_w[Fi * Fo:]
