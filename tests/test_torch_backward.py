"""The backward kernels of the port and their plain versions.

* On the CPU, ``gcn_aggregate_bwd_plain`` and ``gmh_attention_bwd_plain``
  (the gradients written out by hand) against torch autograd of the plain
  forwards, in float64 (rtol = atol = 1e-10: the two differ by rounding
  only); a node with only its loop (row sum exactly 1, where ``jnp.clip``
  passes half the gradient) and rows summing below 1 included.  The JAX
  package's gradients are held to them in tests/test_torch_train_parity.py.
* The plain backwards past the one-block kernels (N = 65, 100 and 361)
  against autograd the same way, and the host-side plan of the tiled
  designs (their tiles cover every row and every entry once; their blocks
  and scratch).
* Tests marked ``cuda`` run each backward kernel against its plain
  version on the card at the training shapes of community_small (B = 80
  train, 20 test; N = 20), grid_small (N = 49) and, tiled, at N = 65, 100
  and grid's 361, and the autograd path of each wrapper; they skip where there is no CUDA device (decided inside
  the test).  This file imports no JAX, so they run on a machine without
  it.  Card tolerance: f32 on both sides, only the summation order differs
  (the kernel's FMA loops against the CPU's or cuBLAS's), scaled by the
  gradient's magnitude: |got - ref| <= 1e-5 (|ref| + max |ref|).  Also on
  the card: batches that are not a multiple of the kernels' cluster size,
  every choice of dx and dadj, and two calls that must give the same bits.
"""

import os

import numpy as np
import pytest
import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.gcn import (
    gcn_aggregate,
    gcn_aggregate_bwd,
    gcn_aggregate_bwd_plain,
    gcn_aggregate_bwd_smem,
    gcn_aggregate_plain,
)
from ccsd_tpu_torch.kernels.gmh_attention import (
    attention_bwd_smem,
    gmh_attention,
    gmh_attention_bwd,
    gmh_attention_bwd_plain,
    gmh_attention_plain,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64_TOL = dict(rtol=1e-10, atol=1e-10)


def _sym(t):
    t = torch.triu(t, 1)
    return t + t.transpose(-1, -2)


def _adj(shape, gen, device="cpu", dtype=torch.float32):
    """A noisy symmetric adjacency with node 1 absent (its row sums to the
    loop alone) and a negative entry pair in every graph (a row below 1)."""
    a = _sym(torch.rand(shape, generator=gen, device=device, dtype=dtype) * 0.8)
    a[..., 1, :] = 0
    a[..., :, 1] = 0
    a[..., 0, 2] = a[..., 2, 0] = -1.5
    return a


def _channels_last(adj):
    return adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def grad_tol_ok(got, ref, rel=1e-5):
    """|got - ref| <= rel (|ref| + max |ref|), elementwise."""
    bound = rel * (ref.abs() + ref.abs().max())
    return bool(((got - ref).abs() <= bound).all() and got.isfinite().all())


@pytest.mark.parametrize("loop,add_loop", [(1.0, True), (2.0, True), (1.0, False)])
def test_gcn_plain_backward_matches_autograd(loop, add_loop):
    g = torch.Generator().manual_seed(0)
    B, N, Fi, Fo = 3, 9, 5, 7
    x = torch.randn(B, N, Fi, generator=g, dtype=torch.float64).requires_grad_()
    adj = _adj((B, N, N), g, dtype=torch.float64).requires_grad_()
    w = torch.randn(Fi, Fo, generator=g, dtype=torch.float64).requires_grad_()
    b = torch.randn(Fo, generator=g, dtype=torch.float64).requires_grad_()
    out = gcn_aggregate_plain(x, adj, w, b, loop, add_loop)
    go = torch.randn(out.shape, generator=g, dtype=torch.float64)
    ref = torch.autograd.grad(out, (x, adj, w, b), go)
    got = gcn_aggregate_bwd_plain(x.detach(), adj.detach(), w.detach(), go, loop, add_loop)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **F64_TOL)
    if add_loop:  # the assigned diagonal gets no gradient
        assert not got[1].diagonal(dim1=-2, dim2=-1).any()


@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("bias", [True, False])
def test_gmh_plain_backward_matches_autograd(layout, bias):
    g = torch.Generator().manual_seed(1)
    B, N, Fi, A, O, H, C = 3, 8, 5, 12, 6, 4, 3
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.randn(B, N, Fi, **f64).requires_grad_()
    adj = _adj((B, C, N, N), g, dtype=torch.float64)
    if layout == "channels-last":
        adj = _channels_last(adj)
    adj.requires_grad_()
    ws = [torch.randn(*s, **f64) * 0.5 for s in
          [(C, Fi, A), (C, A), (C, Fi, A), (C, A), (C, Fi, O), (C, O)]]
    if not bias:
        ws[1] = ws[3] = ws[5] = None
    ws = [None if w is None else w.requires_grad_() for w in ws]
    v, a = gmh_attention_plain(x, adj, *ws, H, O)
    gv, ga = torch.randn(v.shape, **f64), torch.randn(a.shape, **f64)
    inputs = [t for t in (x, adj, *ws) if t is not None]
    ref = iter(torch.autograd.grad((v, a), inputs, (gv, ga)))
    got = gmh_attention_bwd_plain(x.detach(), adj.detach(),
                                  *[None if w is None else w.detach() for w in ws],
                                  gv, ga, H, O)
    for t, grad in zip((x, adj, *ws), got):
        if t is None:
            assert grad is None
        else:
            torch.testing.assert_close(grad, next(ref), **F64_TOL)


def test_backward_wrappers_route_cpu_to_plain_without_counting():
    g = torch.Generator().manual_seed(2)
    x, adj = torch.randn(2, 6, 3, generator=g), _adj((2, 6, 6), g)
    w, go = torch.randn(3, 4, generator=g), torch.randn(2, 6, 4, generator=g)
    before = dict(LAUNCHES)
    for a, r in zip(gcn_aggregate_bwd(x, adj, w, go), gcn_aggregate_bwd_plain(x, adj, w, go)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    C, A, O = 2, 8, 4
    ws = [torch.randn(*s, generator=g) for s in
          [(C, 3, A), (C, A), (C, 3, A), (C, A), (C, 3, O), (C, O)]]
    a4 = _adj((2, C, 6, 6), g)
    gv, ga = torch.randn(2, 6, C * O, generator=g), torch.randn(2, 6, 6, C, generator=g)
    for a, r in zip(gmh_attention_bwd(x, a4, *ws, gv, ga, 4, O),
                    gmh_attention_bwd_plain(x, a4, *ws, gv, ga, 4, O)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    # the launches of the tiled design, each to its plain version
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention_bwd_tiled, gmh_attention_bwd_tiled_plain, gmh_bwd_layout,
        gmh_bwd_layout_plain, gmh_score_grad, gmh_score_grad_plain)

    ac, gm = gmh_bwd_layout(_channels_last(a4), ga)  # rows not unit-stride: adj copied
    ref = gmh_bwd_layout_plain(_channels_last(a4), ga)
    torch.testing.assert_close(ac, ref[0], rtol=0, atol=0)
    torch.testing.assert_close(gm, ref[1], rtol=0, atol=0)
    qk = torch.randn(2, C, 6, 2 * A, generator=g)
    torch.testing.assert_close(gmh_score_grad(qk, gm, 4, O), gmh_score_grad_plain(qk, gm, 4, O),
                               rtol=0, atol=0)
    for a, r in zip(gmh_attention_bwd_tiled(x, a4, *ws, qk, gv),
                    gmh_attention_bwd_tiled_plain(x, a4, *ws, qk, gv)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert LAUNCHES == before


def test_backward_geometry_raises_above_one_block_naming_n():
    """Above N = 64 the backward kernels take row tiles (the host-side plan,
    no kernel built): at N = 65, 100 and 361 the tiles cover every row once,
    the tiles and the chunks of their sums over rows (the same tiles) cover
    every entry of an N x N map once, in ``gmh_score_grad``'s steps (each
    tanh once) and in the last kernel; the clusters hold every graph's row tiles with
    less than a cluster of padding; the scratch has one weight partial a
    cluster and dX's channel partials at their shapes, and the tickets fit
    the device's buffer.  (The forward's tile-pair plan covers the map once
    too.)"""
    from ccsd_tpu_torch.kernels.gcn import MAX_CLUSTER, TICKETS, gcn_bwd_plan, row_tiles
    from ccsd_tpu_torch.kernels.gmh_attention import bwd_plan, tile_pairs

    B, C, Fi, A, O = 8, 8, 32, 32, 32
    for N, nt in ((65, 3), (100, 4), (361, 12)):
        tiles = row_tiles(N)
        assert len(tiles) == nt and all(0 < nr <= 32 for _, nr in tiles)
        rows = np.zeros(N, int)
        for r0, nr in tiles:
            rows[r0:r0 + nr] += 1
        assert (rows == 1).all(), N
        plan = bwd_plan(B, C, N, Fi, A, O)
        assert plan["tiles"] == tiles
        seen = np.zeros((N, N), int)  # gmh_score_grad: block I's steps, each a tile pair
        for I, (r0, nr) in enumerate(tiles):
            for m0, mc in tiles:  # its steps J = 0 .. nt - 1
                seen[r0:r0 + nr, m0:m0 + mc] += 1
        assert (seen == 1).all(), N
        seen = np.zeros((N, N), int)  # the last kernel's columns A'[chunk, tile]
        for r0, nr in tiles:
            for n0, mc in tiles:
                seen[n0:n0 + mc, r0:r0 + nr] += 1
        assert (seen == 1).all(), N
        pairs = np.zeros((N, N), int)
        for i, j in tile_pairs(N):
            pairs[32 * i:32 * (i + 1), 32 * j:32 * (j + 1)] += 1
            if i != j:
                pairs[32 * j:32 * (j + 1), 32 * i:32 * (i + 1)] += 1
        assert (pairs == 1).all(), N
        clusters = plan["clusters"]
        assert (clusters - 1) * MAX_CLUSTER < B * nt <= clusters * MAX_CLUSTER
        P = 2 * A + O
        assert plan["part_w"] == (clusters, C * (Fi * P + P))
        assert plan["part_x"] == (B, C, N, Fi)
        assert plan["tickets"] == MAX_CLUSTER * C + B * nt <= TICKETS
        gplan = gcn_bwd_plan(B, N, Fi, 32)
        assert gplan["chunks"] == tiles
        groups = gplan["groups"]
        assert gplan["part"] == (B * len(gplan["tiles"]) + groups, Fi * 32 + 32)
        assert gplan["tickets"] == groups + 1 <= TICKETS
    # grid's batch of 8 graphs: 96 row tiles, twelve whole clusters
    assert bwd_plan(8, 8, 361, 32, 32, 32)["clusters"] == 12


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("N", [65, 100, 200, 361, 513])
def test_tiled_gcn_backward_plan_covers_tiles_and_chunks(N, B):
    """The host plan of the tiled ``gcn_aggregate_bwd``: its row tiles (a
    block each, the launch's grid (tiles, B)) cover every row once, with at
    most ROW_TILE rows each; every block takes every ROW_TILE-row chunk of
    V's sum once, in chunk order, in passes of the plan's chunks, so its
    fold meets them in chunk order; the groups of BWD_GROUP tiles cover the
    batch's tiles once; the scratch holds a partial a tile and a group, and
    the tickets fit the device's buffer.  At grid's N = 361: 16 tiles of 23
    rows (128 blocks for 8 graphs), twelve chunks in one pass."""
    from ccsd_tpu_torch.kernels.gcn import (BWD_GROUP, ROW_TILE, TICKETS, gcn_bwd_plan,
                                            gcn_rows, row_tiles)

    Fi, Fo = 32, 32
    T = Fi * Fo + Fo
    for rows, pc in ((None, None), (None, 1), (7, 2), (ROW_TILE, 5)):
        plan = gcn_bwd_plan(B, N, Fi, Fo, rows, pc)
        rows = plan["rows"]
        assert rows <= ROW_TILE and (rows == gcn_rows(N) or pc is not None)
        tiles, chunks = plan["tiles"], plan["chunks"]
        assert tiles == row_tiles(N, rows) and chunks == row_tiles(N)
        covered = np.zeros(N, int)
        for r0, nr in tiles:
            assert 0 < nr <= rows
            covered[r0:r0 + nr] += 1
        assert (covered == 1).all(), N
        order = []
        for first, count in plan["passes"]:
            assert 1 <= count <= plan["pass"]
            order += range(first, first + count)
        assert order == list(range(len(chunks))), (N, pc)  # each chunk once, in order
        nt, groups = len(tiles), plan["groups"]
        members = np.zeros(B * nt, int)
        for grp in range(groups):
            members[grp * BWD_GROUP:(grp + 1) * BWD_GROUP] += 1
        assert (members == 1).all() and (groups - 1) * BWD_GROUP < B * nt
        assert plan["part"] == (B * nt + groups, T)
        assert plan["tickets"] == groups + 1 <= TICKETS
    if N == 361:
        plan = gcn_bwd_plan(B, N, Fi, Fo)
        assert plan["rows"] == 23 and len(plan["tiles"]) == 16
        assert plan["passes"] == [(0, 12)]


def test_gcn_backward_takes_degrees_and_routes_cpu_to_plain():
    """A CPU call given the degrees (as the autograd path passes the
    forward's) is the plain backward, with no launch."""
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees_plain

    g = torch.Generator().manual_seed(4)
    x, adj = torch.randn(2, 70, 3, generator=g), _adj((2, 70, 70), g)
    w, go = torch.randn(3, 4, generator=g), torch.randn(2, 70, 4, generator=g)
    before = dict(LAUNCHES)
    got = gcn_aggregate_bwd(x, adj, w, go, deg=gcn_degrees_plain(adj))
    for a, r in zip(got, gcn_aggregate_bwd_plain(x, adj, w, go)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert LAUNCHES == before


@pytest.mark.parametrize("N", [65, 100, 200, 361])
def test_tiled_attention_backward_plans_size_their_scratch(N):
    """The host plans of the tiled attention backward at N = 65, 100, 200
    (ragged) and 361.  ``score_plan``: ``gmh_score_grad``'s cluster holds
    every row tile of a (graph, channel) and block I takes the tiles J = 0
    .. nt - 1, so every tile pair is formed once (each tanh once) and the
    partials' scratch, from which gK[J] sums P(I, J) over I in that order,
    holds each P(I, J) once at its own rows; the gm it takes is the shape
    the layout pass gives (rows of map_row(N) floats: whole 128-byte lines,
    at least N).  ``bwd_plan``: the row-tile kernel's clusters, scratch and
    tickets."""
    from ccsd_tpu_torch.kernels.gcn import MAX_CLUSTER, TICKETS, row_tiles
    from ccsd_tpu_torch.kernels.gmh_attention import (MAX_SCORE_TILES, bwd_plan,
                                                      gmh_bwd_layout_plain, map_row,
                                                      score_plan, score_tiles)

    B, C, Fi, A, O = 8, 8, 32, 32, 32
    tiles = row_tiles(N)
    nt = len(tiles)
    assert nt == score_tiles(N) <= MAX_SCORE_TILES
    splan = score_plan(B, C, N, A)
    assert splan["part_k"] == (B, C, nt, N, A)
    slots = np.zeros((nt, N), int)  # P(I, J) at part_k[b, c, I, rows of J]
    pairs = np.zeros((N, N), int)
    for I, (r0, nr) in enumerate(tiles):
        for m0, mc in tiles:
            slots[I, m0:m0 + mc] += 1
            pairs[r0:r0 + nr, m0:m0 + mc] += 1
    assert (slots == 1).all() and (pairs == 1).all(), N
    ldm = map_row(N)
    assert splan["map"] == (B, C, N, ldm)
    assert ldm % 32 == 0 and N <= ldm < N + 32
    ac, gm = gmh_bwd_layout_plain(torch.zeros(1, 1, N, N), torch.zeros(1, N, N, 1))
    assert ac is None and gm.shape == score_plan(1, 1, N, A)["map"]
    plan = bwd_plan(B, C, N, Fi, A, O)
    assert plan["tiles"] == tiles
    clusters = plan["clusters"]
    assert (clusters - 1) * MAX_CLUSTER < B * nt <= clusters * MAX_CLUSTER
    assert plan["part_w"] == (clusters, C * (Fi * (2 * A + O) + 2 * A + O))
    assert plan["part_x"] == (B, C, N, Fi)
    assert plan["tickets"] == MAX_CLUSTER * C + B * nt <= TICKETS


def test_score_grad_cluster_bounds_n():
    """A ``gmh_score_grad`` cluster holds at most MAX_SCORE_TILES row tiles:
    N = 512 fits, 513 raises naming N (before any kernel is built)."""
    from ccsd_tpu_torch.kernels.gmh_attention import score_tiles

    assert score_tiles(512) == 16
    with pytest.raises(ValueError, match="N=513"):
        score_tiles(513)


@pytest.mark.parametrize("N", [65, 100])
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
def test_tiled_backward_plain_parts_compose(N, layout):
    """The plain versions of the tiled design's launches, chained as the
    wrapper chains the kernels (the layout pass, gQ | gK from the
    symmetrised dL/dA, the row-tile kernel's share), give
    ``gmh_attention_bwd_plain`` in float64 (rtol = atol = 1e-10); the
    layout pass's gm is exactly symmetric with zeros past column N, and its
    ac is the adjacency."""
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention_bwd_tiled_plain, gmh_bwd_layout_plain, gmh_projection_plain,
        gmh_score_grad_plain, map_row)
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees_plain

    B, C, Fi, A, O = 2, 2, 5, 8, 6
    g = torch.Generator().manual_seed(N)
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.randn(B, N, Fi, **f64)
    adj = _adj((B, C, N, N), g, dtype=torch.float64)
    if layout == "channels-last":
        adj = _channels_last(adj)
    ws = [torch.randn(*s, **f64) * 0.5 for s in
          [(C, Fi, A), (C, A), (C, Fi, A), (C, A), (C, Fi, O), (C, O)]]
    gv = torch.randn(B, N, C * O, **f64)
    ga = torch.randn(B, N, N, 2 * C, **f64)[..., :C]
    ac, gm = gmh_bwd_layout_plain(adj, ga)
    assert gm.shape == (B, C, N, map_row(N))
    assert torch.equal(gm[..., :N], gm[..., :N].transpose(-1, -2)) and not gm[..., N:].any()
    assert (ac is None) == (layout == "contiguous")  # copied where rows are not unit-stride
    if ac is not None:
        assert ac.shape == gm.shape and not ac[..., N:].any()
        assert torch.equal(ac[..., :N], adj)
    deg = gcn_degrees_plain(adj)
    qk, _ = gmh_projection_plain(x, adj, deg, *ws)
    gqk = gmh_score_grad_plain(qk, gm, 4, O)
    got = gmh_attention_bwd_tiled_plain(x, adj, *ws, gqk, gv, deg, ac)
    ref = gmh_attention_bwd_plain(x, adj, *ws, gv, ga, 4, O)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **F64_TOL)


# (B, C, N): past the one-block kernels, a ragged last tile at 65 and 100,
# and grid's N = 361, at narrow widths
TILED_F64 = [(2, 2, 65), (1, 2, 100), (1, 2, 361)]


@pytest.mark.parametrize("B,C,N", TILED_F64)
@pytest.mark.parametrize("add_loop", [True, False])
def test_plain_backwards_match_autograd_past_one_block(B, C, N, add_loop):
    """The plain backwards the tiled kernels are held to, at N = 65, 100 and
    361, against torch autograd of the plain forwards in float64 (rtol =
    atol = 1e-10): gcn_aggregate at F 5 -> 6, gmh_attention at C = 2, F_in
    5, attn 8, F_out 6, 4 heads, its adjacency channels-last."""
    g = torch.Generator().manual_seed(N)
    f64 = dict(generator=g, dtype=torch.float64)
    x = torch.randn(B, N, 5, **f64).requires_grad_()
    adj = _adj((B, N, N), g, dtype=torch.float64).requires_grad_()
    w = torch.randn(5, 6, **f64).requires_grad_()
    b = torch.randn(6, **f64).requires_grad_()
    out = gcn_aggregate_plain(x, adj, w, b, 1.0, add_loop)
    go = torch.randn(out.shape, **f64)
    ref = torch.autograd.grad(out, (x, adj, w, b), go)
    got = gcn_aggregate_bwd_plain(x.detach(), adj.detach(), w.detach(), go, 1.0, add_loop)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **F64_TOL)

    a4 = _channels_last(_adj((B, C, N, N), g, dtype=torch.float64)).requires_grad_()
    ws = [(torch.randn(*s, **f64) * 0.5).requires_grad_() for s in
          [(C, 5, 8), (C, 8), (C, 5, 8), (C, 8), (C, 5, 6), (C, 6)]]
    v, m = gmh_attention_plain(x, a4, *ws, 4, 6, 1.0, add_loop)
    gv, ga = torch.randn(v.shape, **f64), torch.randn(m.shape, **f64)
    ref = torch.autograd.grad((v, m), (x, a4, *ws), (gv, ga))
    got = gmh_attention_bwd_plain(x.detach(), a4.detach(), *[t.detach() for t in ws], gv, ga,
                                  4, 6, 1.0, add_loop)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **F64_TOL)


def test_cpu_autograd_of_plain_forward_gives_the_tie_rule():
    """On the CPU the wrappers differentiate the plain forward; at a row sum
    of exactly 1 it takes jnp.clip's half gradient, like the kernels."""
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees_plain

    r = torch.tensor([[[0.0, 0.0], [0.0, 0.0]]], requires_grad=True)  # rows = loop only
    gcn_degrees_plain(r).sum().backward()
    # d = max(r, 1)^-1/2 at r = 1: -1/2 * 1/2 per off-diagonal entry
    assert torch.equal(r.grad, torch.tensor([[[0.0, -0.25], [-0.25, 0.0]]]))


# ----------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernel runs only on the card)")
    return torch.device("cuda")


# (B, N, F_in, F_out): community_small's ScoreNetworkX layers at the train
# and test batches, a whole-graph block at N = 64, and grid_small's N = 49
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(80, 20, 11, 32), (80, 20, 32, 32), (20, 20, 32, 32),
                                   (8, 49, 5, 32), (3, 64, 64, 64)])
@pytest.mark.parametrize("loop,add_loop", [(1.0, True), (2.0, True), (1.0, False)])
def test_gcn_backward_kernel_matches_plain_on_card(cuda, shape, loop, add_loop):
    B, N, Fi, Fo = shape
    g = torch.Generator(device=cuda).manual_seed(N + Fi)
    x = torch.randn(B, N, Fi, generator=g, device=cuda)
    adj = _adj((B, N, N), g, cuda)
    w = torch.randn(Fi, Fo, generator=g, device=cuda) * 0.3
    go = torch.randn(B, N, Fo, generator=g, device=cuda)
    ref = gcn_aggregate_bwd_plain(x, adj, w, go, loop, add_loop)
    for need_x, need_adj in ((True, True), (False, False)):
        before = LAUNCHES["gcn_aggregate_bwd"]
        got = gcn_aggregate_bwd(x, adj, w, go, loop, add_loop, need_x, need_adj)
        torch.cuda.synchronize()
        assert LAUNCHES["gcn_aggregate_bwd"] == before + 1
        for i, (a, r) in enumerate(zip(got, ref)):
            if i == 0 and not need_x or i == 1 and not need_adj:
                assert a is None
                continue
            assert a.shape == r.shape and grad_tol_ok(a, r), (i, (a - r).abs().max().item())


# (B, C, N, F_in, attn, F_out, heads): community_small's first and later
# AttentionLayers at the train and test batches, and grid_small's and
# grid_small_CC_two_stage's later layers (N = 49; head widths 8 and 6)
GMH_TRAIN_SHAPES = [(80, 2, 20, 11, 32, 32, 4), (80, 8, 20, 32, 32, 32, 4),
                    (20, 8, 20, 32, 32, 32, 4), (8, 8, 49, 32, 32, 32, 4),
                    (8, 4, 49, 32, 24, 32, 4)]


def _gmh_case(shape, gen, device, layout):
    B, C, N, Fi, A, O, H = shape
    r = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    x = r(B, N, Fi)
    adj = _adj((B, C, N, N), gen, device)
    if layout == "channels-last":
        adj = _channels_last(adj)
    ws = [r(C, Fi, A) * 0.3, r(C, A) * 0.1, r(C, Fi, A) * 0.3, r(C, A) * 0.1,
          r(C, Fi, O) * 0.3, r(C, O) * 0.1]
    gv, ga = r(B, N, C * O), r(B, N, N, C + 3)[..., 1:C + 1]  # ga: a strided slice
    return x, adj, ws, gv, ga, H, O


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("shape", GMH_TRAIN_SHAPES)
def test_gmh_backward_kernel_matches_plain_on_card(cuda, shape, layout):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, adj, ws, gv, ga, H, O = _gmh_case(shape, g, cuda, layout)
    ref = gmh_attention_bwd_plain(x, adj, *ws, gv, ga, H, O)
    for need in (True, False):
        before = LAUNCHES["gmh_attention_bwd"]
        got = gmh_attention_bwd(x, adj, *ws, gv, ga, H, O, need_x=need, need_adj=need)
        torch.cuda.synchronize()
        assert LAUNCHES["gmh_attention_bwd"] == before + 1
        if need:  # the adjacency's gradient comes in the adjacency's layout
            assert got[1].stride() == adj.stride()
        else:
            assert got[0] is None and got[1] is None
        for i, (a, r) in enumerate(zip(got, ref)):
            if a is None:
                continue
            assert a.shape == r.shape and grad_tol_ok(a, r), (i, (a - r).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("need_x,need_adj", [(True, True), (True, False), (False, True),
                                             (False, False)])
def test_gcn_backward_kernel_gives_what_is_asked_on_card(cuda, need_x, need_adj):
    """Each of dx and dadj comes out right where it is asked for and is None
    where it is not; dW and dbias come out right either way."""
    B, N, Fi, Fo = 80, 20, 32, 32
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(B, N, Fi, generator=g, device=cuda)
    adj = _adj((B, N, N), g, cuda)
    w = torch.randn(Fi, Fo, generator=g, device=cuda) * 0.3
    go = torch.randn(B, N, Fo, generator=g, device=cuda)
    ref = gcn_aggregate_bwd_plain(x, adj, w, go)
    got = gcn_aggregate_bwd(x, adj, w, go, need_x=need_x, need_adj=need_adj)
    torch.cuda.synchronize()
    for i, (a, r, asked) in enumerate(zip(got, ref, (need_x, need_adj, True, True))):
        if not asked:
            assert a is None
            continue
        assert a.shape == r.shape and grad_tol_ok(a, r), (i, (a - r).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [7, 20, 80])
def test_backward_kernels_take_any_batch_on_card(cuda, B):
    """The blocks are padded to a multiple of the cluster size (8): batches
    of 7 and 20 graphs (the last cluster partly padding) and 80 agree with
    the plain backwards."""
    g = torch.Generator(device=cuda).manual_seed(B)
    x = torch.randn(B, 20, 32, generator=g, device=cuda)
    adj = _adj((B, 20, 20), g, cuda)
    w = torch.randn(32, 32, generator=g, device=cuda) * 0.3
    go = torch.randn(B, 20, 32, generator=g, device=cuda)
    for a, r in zip(gcn_aggregate_bwd(x, adj, w, go), gcn_aggregate_bwd_plain(x, adj, w, go)):
        assert grad_tol_ok(a, r), (a - r).abs().max().item()
    x, adj, ws, gv, ga, H, O = _gmh_case((B, 8, 20, 32, 32, 32, 4), g, cuda, "channels-last")
    for a, r in zip(gmh_attention_bwd(x, adj, *ws, gv, ga, H, O),
                    gmh_attention_bwd_plain(x, adj, *ws, gv, ga, H, O)):
        assert grad_tol_ok(a, r), (a - r).abs().max().item()


@pytest.mark.cuda
def test_backward_kernels_repeat_bit_for_bit_on_card(cuda):
    """No float atomics: two calls on the same inputs give the same bits
    (the batch and channel sums run in a fixed order)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(80, 20, 32, generator=g, device=cuda)
    adj = _adj((80, 20, 20), g, cuda)
    w = torch.randn(32, 32, generator=g, device=cuda) * 0.3
    go = torch.randn(80, 20, 32, generator=g, device=cuda)
    first = gcn_aggregate_bwd(x, adj, w, go)
    for a, b in zip(first, gcn_aggregate_bwd(x, adj, w, go)):
        assert torch.equal(a, b)
    x, adj, ws, gv, ga, H, O = _gmh_case((80, 8, 20, 32, 32, 32, 4), g, cuda, "channels-last")
    first = gmh_attention_bwd(x, adj, *ws, gv, ga, H, O)
    for a, b in zip(first, gmh_attention_bwd(x, adj, *ws, gv, ga, H, O)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_autograd_runs_the_backward_kernels_on_card(cuda):
    """A CUDA tensor that needs a gradient goes through the forward kernel
    and, on backward, through the backward kernel: one launch each, and the
    gradients of the plain backward."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, N, Fi, Fo = 20, 20, 11, 32
    x = torch.randn(B, N, Fi, generator=g, device=cuda).requires_grad_()
    adj = _adj((B, N, N), g, cuda)
    w = (torch.randn(Fi, Fo, generator=g, device=cuda) * 0.3).requires_grad_()
    b = torch.randn(Fo, generator=g, device=cuda).requires_grad_()
    go = torch.randn(B, N, Fo, generator=g, device=cuda)
    before = dict(LAUNCHES)
    gcn_aggregate(x, adj, w, b).backward(go)
    torch.cuda.synchronize()
    assert LAUNCHES["gcn_aggregate"] == before["gcn_aggregate"] + 1
    assert LAUNCHES["gcn_aggregate_bwd"] == before["gcn_aggregate_bwd"] + 1
    ref = gcn_aggregate_bwd_plain(x.detach(), adj, w.detach(), go, need_adj=False)
    for t, r in zip((x, w, b), (ref[0], ref[2], ref[3])):
        assert grad_tol_ok(t.grad, r)

    x, adj, ws, gv, ga, H, O = _gmh_case((20, 8, 20, 32, 32, 32, 4), g, cuda,
                                         "channels-last")
    leaves = [t.requires_grad_() for t in (x, adj, *ws)]
    before = dict(LAUNCHES)
    v, a = gmh_attention(*leaves, H, O)
    torch.autograd.backward((v, a), (gv, ga))
    torch.cuda.synchronize()
    assert LAUNCHES["gmh_attention"] == before["gmh_attention"] + 1
    assert LAUNCHES["gmh_attention_bwd"] == before["gmh_attention_bwd"] + 1
    ref = gmh_attention_bwd_plain(*[t.detach() for t in leaves], gv, ga, H, O)
    for t, r in zip(leaves, ref):
        assert grad_tol_ok(t.grad, r)


@pytest.mark.cuda
def test_fused_kernels_raise_naming_the_missing_backward_on_card(cuda):
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores

    x = torch.randn(4, 20, 11, device=cuda, requires_grad=True)
    adj = torch.rand(4, 2, 20, 20, device=cuda)
    with pytest.raises(NotImplementedError, match="channel_agg, gmh_scores"):
        channel_agg(adj, x)
    q = torch.randn(4, 2, 20, 32, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        gmh_scores(q, q.detach(), 4, 32)


def _graph_configs():
    from ccsd_tpu_torch.utils.config import load_yaml

    out = []
    for name in sorted(os.listdir(os.path.join(ROOT, "config"))):
        with open(os.path.join(ROOT, "config", name)) as f:
            cfg = load_yaml(f.read())
        if cfg.get("model", {}).get("adim") and cfg.get("data", {}).get("max_node_num"):
            out.append((name[: -len(".yaml")], cfg["data"], cfg["model"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _, _ in _graph_configs()])
def test_backward_geometry_fits_every_graph_config(cuda, name):
    """Both backward kernels' blocks fit the card's shared memory for every
    layer of every graph config, by the libraries' own counts: one block a
    graph up to N = 64, row tiles above (grid: N = 361), with dA and
    without."""
    from ccsd_tpu_torch.kernels.build import SMEM_LIMIT
    from ccsd_tpu_torch.kernels.gmh_attention import head_split

    _, data, model = next(c for c in _graph_configs() if c[0] == name)
    N, F, nhid = data["max_node_num"], data["max_feat_num"], model["nhid"]
    for need_adj in (True, False):
        for Fi in (F, nhid):
            assert 0 < gcn_aggregate_bwd_smem(N, Fi, nhid, need_adj) <= SMEM_LIMIT, (N, Fi)
        for Fi, A in ((F, nhid), (nhid, model["adim"])):
            H = head_split(A, model["num_heads"])[0]
            assert 0 < attention_bwd_smem(N, Fi, A, nhid, H, need_adj) <= SMEM_LIMIT, (N, Fi)


# (B, N, F_in, F_out) and (B, C, N, F_in, attn, F_out, heads) past the
# one-block kernels: ragged last tiles at N = 65 and 100, grid's layers at
# N = 361 (B = 8; C = 2 on F_in 5 and C = 8 on F_in 32), and a batch that
# leaves the last cluster partly padding
GCN_TILED = [(8, 65, 32, 32), (3, 100, 5, 32), (8, 361, 5, 32), (8, 361, 32, 32),
             (1, 65, 32, 32), (3, 65, 5, 32), (1, 97, 32, 32), (3, 97, 5, 32),
             (8, 97, 32, 32), (1, 100, 32, 32), (8, 100, 32, 32), (1, 361, 32, 32),
             (3, 361, 5, 32)]
GMH_TILED = [(8, 8, 65, 32, 32, 32, 4), (3, 2, 100, 5, 32, 32, 4), (8, 2, 361, 5, 32, 32, 4),
             (8, 8, 361, 32, 32, 32, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GCN_TILED)
@pytest.mark.parametrize("add_loop", [True, False])
def test_tiled_gcn_backward_matches_plain_on_card(cuda, shape, add_loop):
    """Above N = 64 the row-tile kernel (after one gcn_degrees launch)
    against the plain backward, for every choice of dx and dadj, on padded
    graphs (each graph's trailing nodes absent, node 1 too: rows at the
    degree clamp's tie); two calls give the same bits."""
    B, N, Fi, Fo = shape
    g = torch.Generator(device=cuda).manual_seed(N + Fi + B)
    x = torch.randn(B, N, Fi, generator=g, device=cuda)
    adj = _padded(_adj((B, N, N), g, cuda), g)
    w = torch.randn(Fi, Fo, generator=g, device=cuda) * 0.3
    go = torch.randn(B, N, Fo, generator=g, device=cuda)
    ref = gcn_aggregate_bwd_plain(x, adj, w, go, 1.0, add_loop)
    for need_x, need_adj in ((True, True), (True, False), (False, True), (False, False)):
        before = dict(LAUNCHES)
        got = gcn_aggregate_bwd(x, adj, w, go, 1.0, add_loop, need_x, need_adj)
        again = gcn_aggregate_bwd(x, adj, w, go, 1.0, add_loop, need_x, need_adj)
        torch.cuda.synchronize()
        assert LAUNCHES["gcn_aggregate_bwd"] == before["gcn_aggregate_bwd"] + 2
        assert LAUNCHES["gcn_degrees"] == before["gcn_degrees"] + 2
        for i, (a, r, asked) in enumerate(zip(got, ref, (need_x, need_adj, True, True))):
            if not asked:
                assert a is None and again[i] is None
                continue
            assert torch.equal(a, again[i]), i
            assert a.shape == r.shape and grad_tol_ok(a, r), (i, (a - r).abs().max().item())


def _padded(adj, gen):
    """adj (B, N, N) with graph b's nodes from N // 2 + 1 on absent (rows and
    columns zero) for a random count of them, as a training batch pads."""
    B, N = adj.shape[0], adj.shape[-1]
    n = torch.randint(N // 2, N + 1, (B,), generator=gen, device=adj.device)
    f = (torch.arange(N, device=adj.device)[None] < n[:, None]).to(adj.dtype)
    return adj * f[:, :, None] * f[:, None, :]


@pytest.mark.cuda
def test_tiled_gcn_backward_through_autograd_reads_the_forward_degrees_on_card(cuda):
    """At grid's N = 361 the gradient through ``gcn_aggregate`` equals the
    direct backward call's bit for bit (x, adj, the weight and the bias),
    and one forward and backward launch gcn_degrees once: the backward
    reads the forward's degrees."""
    B, N, Fi, Fo = 8, 361, 32, 32
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(B, N, Fi, generator=g, device=cuda)
    adj = _padded(_adj((B, N, N), g, cuda), g)
    w = torch.randn(Fi, Fo, generator=g, device=cuda) * 0.3
    b = torch.randn(Fo, generator=g, device=cuda)
    go = torch.randn(B, N, Fo, generator=g, device=cuda)
    for need_adj in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, adj, w, b)]
        leaves[1].requires_grad_(need_adj)
        before = dict(LAUNCHES)
        gcn_aggregate(*leaves).backward(go)
        torch.cuda.synchronize()
        counts = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        assert counts == {**{k: 0 for k in LAUNCHES}, "gcn_aggregate": 1, "gcn_degrees": 1,
                          "gcn_aggregate_bwd": 1}, counts
        want = gcn_aggregate_bwd(x, adj, w, go, need_x=True, need_adj=need_adj)
        torch.cuda.synchronize()
        for leaf, ref in zip(leaves, want):
            assert (leaf.grad is None) == (ref is None)
            assert ref is None or torch.equal(leaf.grad, ref)


def _earlier_tiled_bytes(N, Fi, Fo, need_adj):
    """Shared bytes of a block of the earlier tiled gcn_aggregate_bwd (a
    block a 32-row tile; commit 9375191's TiledLayout): W, X of every row,
    G[R], two chunk buffers of A' columns and of G, V, dY, the partial, d;
    for dA also Y, A[R, :], P1 and dr."""
    def ld4(n):
        return n + (12 - n % 8) % 8

    def r4(n):
        return (n + 3) & ~3

    ldo, ldx, ldc = ld4(Fo), ld4(Fi), ld4(32)
    floats = (Fi * ldo + N * ldx + 32 * ldo + 2 * 32 * ldc + 2 * 32 * ldo + 2 * 32 * ldo
              + r4(Fi * Fo + Fo) + r4(N))
    if need_adj:
        floats += N * ldo + 32 * ld4(N) + 32 * ldo + 32
    return 4 * floats


@pytest.mark.cuda
@pytest.mark.parametrize("Fi,need_adj", [(5, False), (5, True), (32, False), (32, True)])
def test_tiled_gcn_backward_takes_the_earlier_largest_n_on_card(cuda, Fi, need_adj):
    """The largest N the earlier tiled design took at F_out 32 (its block
    within the card's shared memory beside its 4-byte static flag) still
    runs, with dA and without, and agrees with the plain backward."""
    from ccsd_tpu_torch.kernels.build import SMEM_LIMIT

    Fo = 32
    N = 65
    while _earlier_tiled_bytes(N + 1, Fi, Fo, need_adj) <= SMEM_LIMIT - 4:
        N += 1
    assert N > 400, N
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(1, N, Fi, generator=g, device=cuda)
    adj = _adj((1, N, N), g, cuda)
    w = torch.randn(Fi, Fo, generator=g, device=cuda) * 0.3
    go = torch.randn(1, N, Fo, generator=g, device=cuda)
    got = gcn_aggregate_bwd(x, adj, w, go, need_x=True, need_adj=need_adj)
    torch.cuda.synchronize()
    for a, r in zip(got, gcn_aggregate_bwd_plain(x, adj, w, go, need_x=True,
                                                 need_adj=need_adj)):
        assert (a is None) == (r is None)
        assert a is None or grad_tol_ok(a, r), (N, (a - r).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("shape", GMH_TILED)
def test_tiled_gmh_backward_matches_plain_on_card(cuda, shape, layout):
    """Above N = 64 the five launches (gcn_degrees, gmh_projection, the
    layout pass, gmh_score_grad, the row-tile kernel) against the plain
    backward, in both adjacency layouts and for every choice of dx and dadj
    (dadj in adj's layout); two calls give the same bits; each of the
    three backward kernels alone against its plain version (the layout
    pass exactly), the row-tile kernel for every choice of dx and dadj."""
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention_bwd_tiled, gmh_attention_bwd_tiled_plain, gmh_bwd_layout,
        gmh_bwd_layout_plain, gmh_score_grad, gmh_score_grad_plain)

    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, adj, ws, gv, ga, H, O = _gmh_case(shape, g, cuda, layout)
    ref = gmh_attention_bwd_plain(x, adj, *ws, gv, ga, H, O)
    for need_x, need_adj in ((True, True), (True, False), (False, True), (False, False)):
        before = dict(LAUNCHES)
        got = gmh_attention_bwd(x, adj, *ws, gv, ga, H, O, need_x=need_x, need_adj=need_adj)
        again = gmh_attention_bwd(x, adj, *ws, gv, ga, H, O, need_x=need_x,
                                  need_adj=need_adj)
        torch.cuda.synchronize()
        for k in ("gmh_attention_bwd_tiled", "gmh_score_grad", "gmh_bwd_layout",
                  "gmh_projection", "gcn_degrees"):
            assert LAUNCHES[k] == before[k] + 2, k
        assert LAUNCHES["gmh_attention_bwd"] == before["gmh_attention_bwd"]
        if need_adj:
            assert got[1].stride() == adj.stride()
        for i, (a, r) in enumerate(zip(got, ref)):
            if i == 0 and not need_x or i == 1 and not need_adj:
                assert a is None and again[i] is None
                continue
            assert torch.equal(a, again[i]), i
            assert a.shape == r.shape and grad_tol_ok(a, r), (i, (a - r).abs().max().item())
    B, N, C = x.shape[0], x.shape[1], adj.shape[1]
    ac, gm = gmh_bwd_layout(adj, ga)
    want = gmh_bwd_layout_plain(adj, ga)
    assert torch.equal(gm, want[1]) and (ac is None) == (want[0] is None)
    assert ac is None or torch.equal(ac, want[0])
    qk = torch.randn(B, C, N, 2 * ws[0].shape[-1], generator=g, device=cuda)
    got, want = gmh_score_grad(qk, gm, H, O), gmh_score_grad_plain(qk, gm, H, O)
    assert torch.equal(got, gmh_score_grad(qk, gm, H, O))
    assert grad_tol_ok(got, want), (got - want).abs().max().item()
    deg = gcn_degrees(adj)
    for need_x, need_adj in ((True, True), (False, False)):
        got = gmh_attention_bwd_tiled(x, adj, *ws, qk, gv, deg, ac, need_x=need_x,
                                      need_adj=need_adj)
        want = gmh_attention_bwd_tiled_plain(x, adj, *ws, qk, gv, need_x=need_x,
                                             need_adj=need_adj)
        for i, (a, r) in enumerate(zip(got, want)):
            assert (a is None) == (r is None), i
            assert a is None or grad_tol_ok(a, r), (i, (a - r).abs().max().item())


@pytest.mark.cuda
def test_unfused_mlp_conv_layer_trains_on_card(cuda):
    """The unfused AttentionLayer with conv="MLP" takes its value conv per
    channel, on a channel slice of a channels-last adjacency: forward and
    backward on the card against a float64 CPU copy (rtol = atol = 1e-5 on
    the outputs, 1e-4 of each gradient's magnitude: f32 rounding through
    the layer and back)."""
    import copy

    from ccsd_tpu_torch.models.attention import AttentionLayer

    g = torch.Generator().manual_seed(3)
    layer = AttentionLayer(2, 32, 32, 32, 8, 8, conv="MLP", generator=g)
    B, N = 20, 20
    x = torch.randn(B, N, 32, generator=g)
    adj = _channels_last(_sym(torch.rand(B, 8, N, N, generator=g)))
    flags = torch.ones(B, N)
    flags[:, 15:] = 0
    card = copy.deepcopy(layer).to(cuda)
    xc, ac = (t.to(cuda).requires_grad_() for t in (x, adj))
    before = dict(LAUNCHES)
    hc, mc = card(xc, ac, flags.to(cuda))
    (hc.sum() + (mc * mc).sum()).backward()
    torch.cuda.synchronize()
    assert LAUNCHES["gcn_aggregate"] == before["gcn_aggregate"] + 8
    assert LAUNCHES["gcn_aggregate_bwd"] == before["gcn_aggregate_bwd"] + 8
    ref = layer.double()
    xr, ar = (t.double().requires_grad_() for t in (x, adj))
    hr, mr = ref(xr, ar, flags.double())
    (hr.sum() + (mr * mr).sum()).backward()
    for o, r in ((hc, hr), (mc, mr)):
        torch.testing.assert_close(o.detach().cpu().double(), r.detach(), rtol=1e-5, atol=1e-5)
    for a, r in [(xc.grad, xr.grad), (ac.grad, ar.grad)] + [
            (p.grad, q.grad) for p, q in zip(card.parameters(), ref.parameters())]:
        assert grad_tol_ok(a.cpu().double(), r, 1e-4)


@pytest.mark.cuda
def test_fused_training_raises_on_card_naming_the_missing_backward(cuda, tmp_path):
    """model.fused trains the channel-folded networks, whose kernels have no
    backward yet: the first step raises and says which."""
    from ccsd_tpu_torch.training.trainer import Trainer
    from ccsd_tpu_torch.utils.config import get_config

    cfg = get_config("community_small", 0, ROOT)
    cfg.model.fused, cfg.folder = True, str(tmp_path)
    trainer = Trainer(cfg, log=False)
    x, adj = next(iter(trainer.train_loader))
    with pytest.raises(NotImplementedError, match="channel_agg, gmh_scores"):
        trainer.train_step(x, adj)
