"""Package boundaries of the port and its on-card kernel checks.

* Nothing in ccsd_tpu_torch/ or chip_smoke.py imports jax, jaxlib, optax,
  flax or ccsd_tpu, nor networkx, toponetx or sklearn, which the card's
  machine lacks (an AST walk), and every module imports in a process
  where none of those can be imported.
* Entry points default to CUDA and raise without it.
* Tests marked ``cuda`` run each kernel against its plain version on the
  card; they skip where there is no CUDA device (decided inside the test).
  This file imports no JAX, so they run on a machine without it.
"""

import ast
import math
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import ccsd_tpu_torch
from ccsd_tpu_torch import default_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ccsd_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "ccsd_tpu", "networkx", "toponetx", "sklearn")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(ROOT, "scripts", f) for f in ("port_quality_run.py", "cc_finite_sweep.py",
                                                "f32_bitcheck.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ccsd_tpu_torch.__path__, "ccsd_tpu_torch."))


def test_import_guard_covers_every_kernel_module():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"chip_smoke.py", "ccsd_tpu_torch/kernels/channel_agg.py",
            "ccsd_tpu_torch/kernels/gmh_scores.py", "ccsd_tpu_torch/eval/stats.py",
            "ccsd_tpu_torch/eval/orbits/__init__.py", "ccsd_tpu_torch/data/cc_codec.py",
            "ccsd_tpu_torch/ops/hodge.py", "ccsd_tpu_torch/models/hodge_nn.py",
            "ccsd_tpu_torch/models/score_a_cc.py", "ccsd_tpu_torch/models/score_f.py",
            "scripts/port_quality_run.py", "scripts/f32_bitcheck.py",
            "ccsd_tpu_torch/diffusion/two_stage.py",
            "ccsd_tpu_torch/training/two_stage_trainer.py",
            "ccsd_tpu_torch/sampling/two_stage_sampler.py",
            "ccsd_tpu_torch/models/score_x.py", "ccsd_tpu_torch/models/nn.py",
            "ccsd_tpu_torch/diffusion/losses.py", "ccsd_tpu_torch/diffusion/solvers.py"} <= rel


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert {"ccsd_tpu_torch.sampling.sampler", "ccsd_tpu_torch.kernels.channel_agg",
            "ccsd_tpu_torch.kernels.gmh_scores", "ccsd_tpu_torch.eval.mmd",
            "ccsd_tpu_torch.eval.graphs", "ccsd_tpu_torch.eval.stats",
            "ccsd_tpu_torch.eval.orbits", "ccsd_tpu_torch.eval.cc_stats",
            "ccsd_tpu_torch.data.complex", "ccsd_tpu_torch.data.lifts",
            "ccsd_tpu_torch.data.cc_codec", "ccsd_tpu_torch.ops.cells",
            "ccsd_tpu_torch.diffusion.two_stage", "ccsd_tpu_torch.training.two_stage_trainer",
            "ccsd_tpu_torch.sampling.two_stage_sampler"} <= set(mods)
    script = (
        "import importlib, sys\n"
        f"for m in {FORBIDDEN!r}:\n    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from ccsd_tpu_torch.sampling.sampler import Sampler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler({"data": {}}, np.zeros((1, 4, 4)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")


def test_kernels_raise_for_wrong_inputs_before_any_build():
    from ccsd_tpu_torch.kernels.gcn import check_cuda_f32

    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        check_cuda_f32("k", x=meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernel runs only on the card)")
    return torch.device("cuda")


# community_small's layers, a whole-graph block at N = 64 and F = 128, and
# row tiles reading the gcn_degrees pass: grid's layers (N = 361) at B = 8
# and 1, N = 65, 97 and 100 (ragged last tiles), and the largest graphs the
# earlier 32-row tiles held at F 32 -> 32, 5 -> 32 and 128 -> 128 (the plan
# takes fewer rows a tile where a block of gcn_rows(N) would not fit)
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 20, 11, 32), (128, 20, 32, 32), (3, 64, 128, 128),
                                   (8, 361, 5, 32), (8, 361, 32, 32), (1, 361, 5, 32),
                                   (1, 361, 32, 32), (8, 65, 5, 32), (1, 97, 32, 32),
                                   (8, 100, 32, 32), (1, 860, 32, 32), (1, 1400, 5, 32),
                                   (2, 231, 128, 128)])
def test_gcn_kernel_matches_plain_on_card(cuda, shape):
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.gcn import gcn_aggregate, gcn_aggregate_plain

    B, N, Fi, Fo = shape
    before = dict(LAUNCHES)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, N, Fi, device=cuda, generator=g)
    adj = (torch.rand(B, N, N, device=cuda, generator=g) > 0.7).float()
    adj = torch.triu(adj, 1)
    adj = adj + adj.transpose(1, 2)
    w = torch.randn(Fi, Fo, device=cuda, generator=g)
    b = torch.randn(Fo, device=cuda, generator=g)
    for bias, loop in ((b, 1.0), (b, 2.0), (None, 2.0)):
        out = gcn_aggregate(x, adj, w, bias, loop)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, gcn_aggregate_plain(x, adj, w, bias, loop),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(out, gcn_aggregate(x, adj, w, None, 2.0))  # bit for bit again
    # the degree pass runs only where a graph is cut into row tiles
    assert LAUNCHES["gcn_aggregate"] == before["gcn_aggregate"] + 4
    assert LAUNCHES["gcn_degrees"] == before["gcn_degrees"] + (4 if N > 64 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,Fi", [(2, 11), (8, 32)])
def test_gmh_kernel_matches_plain_on_card(cuda, C, Fi):
    from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, gmh_attention_plain

    B, N, A, O, H = 128, 20, 32, 32, 4
    g = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    x = r(B, N, Fi)
    adj = torch.rand(B, C, N, N, device=cuda, generator=g)
    adj = torch.triu(adj, 1)
    adj = adj + adj.transpose(-1, -2)
    w = [r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, O), r(C, O)]
    out = gmh_attention(x, adj, *w, H, O)
    torch.cuda.synchronize()
    ref = gmh_attention_plain(x, adj, *w, H, O)
    for o, rr in zip(out, ref):
        torch.testing.assert_close(o, rr, rtol=1e-5, atol=1e-5)


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


def _bf16_agg_tol(adj, x):
    """channel_agg in bf16, kernel vs plain, element by element: both round
    x and each norm element to bf16, but their f32 norm elements (degrees
    summed in another order) may round to the two bf16 neighbours of a
    value, one bf16 ulp of |norm| apart; summed against |x| over m, plus
    the f32 tolerance."""
    from ccsd_tpu_torch.kernels.gcn import gcn_norm
    from ccsd_tpu_torch.kernels.gmh_scores import round_bf16

    a = adj if adj.dim() == 4 else adj.unflatten(1, (-1, x.shape[1]))
    norm = gcn_norm(a).abs()
    ulp = torch.exp2(torch.floor(torch.log2(norm.clamp_min(1e-30))) - 7)
    bound = (ulp @ round_bf16(x).abs()[:, None]).reshape(*adj.shape[:-1], x.shape[-1])
    return bound + 1e-5


# (B, C, N, F): community_small's first and later fused layers and grid's
# (N = 361: row tiles reading the gcn_degrees pass)
@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "channels-last", "folded"])
@pytest.mark.parametrize("shape", [(128, 2, 20, 11), (128, 8, 20, 32),
                                   (8, 2, 361, 5), (8, 8, 361, 32)])
def test_channel_agg_kernel_matches_plain_on_card(cuda, shape, layout, bf16):
    """The adjacency in the layouts the fused layer passes (a first layer's
    contiguous, a later layer's channels-last view) and the probes' folded
    (B, C*N, N) form; f32 within rtol = atol = 1e-5, bf16 within
    _bf16_agg_tol."""
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain

    B, C, N, F = shape
    g = torch.Generator(device=cuda).manual_seed(N + C)
    adj = _sym(torch.rand(B, C, N, N, device=cuda, generator=g))
    if layout == "channels-last":
        adj = adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    elif layout == "folded":
        adj = adj.view(B, C * N, N)
    x = torch.randn(B, N, F, device=cuda, generator=g)
    before = dict(LAUNCHES)
    out = channel_agg(adj, x, bf16=bf16)
    torch.cuda.synchronize()
    assert LAUNCHES["channel_agg"] == before["channel_agg"] + 1
    assert LAUNCHES["gcn_degrees"] == before["gcn_degrees"] + (N > 64)
    ref = channel_agg_plain(adj, x, bf16=bf16)
    assert out.shape == ref.shape
    if bf16:
        err = (out - ref).abs()
        assert bool((err <= _bf16_agg_tol(adj, x)).all()), f"max error {err.max().item():.3e}"
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("add_loop,loop", [(True, 1.0), (True, 2.0), (False, 1.0)])
@pytest.mark.parametrize("shape", [(8, 1, 361), (8, 8, 361), (2, 3, 70)])
def test_gcn_degrees_kernel_matches_plain_on_card(cuda, shape, add_loop, loop, layout):
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees, gcn_degrees_plain

    B, C, N = shape
    g = torch.Generator(device=cuda).manual_seed(N)
    adj = _sym(torch.rand(B, C, N, N, device=cuda, generator=g))
    adj.diagonal(dim1=-2, dim2=-1).fill_(0.5)
    if layout == "channels-last":
        adj = adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    out = gcn_degrees(adj, add_loop, loop)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, gcn_degrees_plain(adj, add_loop, loop),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("bf16", [False, True])
def test_gmh_scores_kernel_matches_plain_on_card(cuda, C, bf16):
    """Q and K as the fused layer hands them over: strided column blocks of
    one (C, B, N, 2A + O) projection.  bf16: both sides round each head sum
    to bf16 once, but their f32 sums may round to the two neighbours of the
    exact sum, one bf16 ulp of |s| apart, which tanh (slope <= 1) and the
    1/sqrt(O) scale carry to the map."""
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

    B, N, A, H, O = 128, 20, 32, 4, 32
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(C, B, N, 2 * A + O, device=cuda, generator=g).transpose(0, 1)
    q, k = qkv[..., :A], qkv[..., A:2 * A]
    out = gmh_scores(q, k, H, O, bf16=bf16)
    torch.cuda.synchronize()
    ref = gmh_scores_plain(q, k, H, O, bf16=bf16)
    tol = 1e-5
    if bf16:
        s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, -1),
                         k.reshape(B, C, N, H, -1))
        tol += _bf16_ulp(s.abs().max().item()) / math.sqrt(O)
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["GCN", "MLP"])
def test_fused_attention_layer_on_card_matches_cpu(cuda, conv):
    """The fused layer hands its kernels strided Q and K views.  f32 scores,
    against a float64 CPU copy: the card's f32 rounding only (rtol = atol =
    1e-5); float64 because f32 CPU results were seen to move between
    processes on the card's machine (chip_smoke.py, MODEL_TOL)."""
    import copy

    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.attention import AttentionLayer

    g = torch.Generator().manual_seed(2)
    layer = AttentionLayer(2, 32, 32, 32, 8, 8, conv=conv, fused=True, generator=g).eval()
    B, N = 128, 20
    x = torch.randn(B, N, 32, generator=g)
    adj = torch.rand(B, 8, N, N, generator=g)
    adj = torch.triu(adj, 1)
    adj = adj + adj.transpose(-1, -2)
    flags = torch.ones(B, N)
    flags[:, 15:] = 0
    card = copy.deepcopy(layer).to(cuda)
    reset_launches()
    with torch.no_grad():
        got = card(x.to(cuda), adj.to(cuda), flags.to(cuda))
        torch.cuda.synchronize()
        ref = layer.double()(x.double(), adj.double(), flags.double())
    assert LAUNCHES["channel_agg"] == 1 and LAUNCHES["gmh_scores"] == 1
    for o, r in zip(got, ref):
        torch.testing.assert_close(o.cpu().double(), r, rtol=1e-5, atol=1e-5)


def _sym(t):
    t = torch.triu(t, 1)
    return t + t.transpose(-1, -2)


# the shapes of the redesigned attention kernels: N of enzymes_small (12),
# ego_small (18), community_small (20) and grid_small (49); head widths 8
# (adim 32), 6 (adim 24) and 3 (adim 12) at 4 heads; C of a first (2) and a
# later (8) AttentionLayer; B of grid_small (8), of the sampler (128) and of
# qm9 (1024), so that gmh_scores runs with one channel a block and with
# several
@pytest.mark.cuda
@pytest.mark.parametrize("B", [8, 128, 1024])
@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("ds", [8, 6, 3])
@pytest.mark.parametrize("N", [12, 18, 20, 49])
def test_gmh_kernel_matches_plain_on_card_at_every_shape(cuda, N, ds, C, B):
    """Contiguous and channels-last (a later layer's) adjacency."""
    from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, gmh_attention_plain

    H = 4
    A = O = H * ds
    Fi = 11 if C == 2 else A
    g = torch.Generator(device=cuda).manual_seed(N * 100 + ds * 10 + C)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    x = r(B, N, Fi)
    adj = _sym(torch.rand(B, C, N, N, device=cuda, generator=g))
    w = [r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, O), r(C, O)]
    ref = gmh_attention_plain(x, adj, *w, H, O)
    channels_last = adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    for a in (adj, channels_last):
        out = gmh_attention(x, a, *w, H, O)
        torch.cuda.synchronize()
        for o, rr in zip(out, ref):
            torch.testing.assert_close(o, rr, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B", [8, 128, 1024])
@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("ds", [8, 6, 3])
@pytest.mark.parametrize("N", [12, 18, 20, 49])
def test_gmh_scores_kernel_matches_plain_on_card_at_every_shape(cuda, N, ds, C, B, bf16):
    """Q and K as strided column blocks of one projection.  bf16: one bf16
    ulp of each head sum over sqrt(O), element by element (the tensor
    core's f32 sums may round to the other bf16 neighbour)."""
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

    H = 4
    A = O = H * ds
    g = torch.Generator(device=cuda).manual_seed(N * 100 + ds * 10 + C)
    qkv = torch.randn(C, B, N, 2 * A + O, device=cuda, generator=g).transpose(0, 1)
    q, k = qkv[..., :A], qkv[..., A:2 * A]
    out = gmh_scores(q, k, H, O, bf16=bf16)
    torch.cuda.synchronize()
    ref = gmh_scores_plain(q, k, H, O, bf16=bf16)
    tol = torch.full_like(ref, 1e-5)
    if bf16:
        s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, ds),
                         k.reshape(B, C, N, H, ds))
        ulp = torch.exp2(torch.floor(torch.log2(s.abs().clamp_min(1e-30))) - 7)
        b = ulp.mean(dim=2) / math.sqrt(O)
        tol += ((b + b.transpose(-1, -2)) / 2).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    err = (out - ref).abs()
    assert bool((err <= tol).all()), f"max error {err.max().item():.3e}"


# the tiled designs (N > 64): one ragged tile past the one-block limit (65),
# an N that is not a multiple of the tile (100: three tiles of 32 and one
# of 4), and grid's 361 (eleven tiles of 32 and one of 9) at its batch
TILED = [(3, 65), (3, 100), (8, 361)]
# the tile-pair stage's: one tile past the one-block limit, a ragged last
# tile of 1 and of 4 rows, grid's N (a last tile of 9), at B = 1, 3 and 8,
# with grid's four heads of width 8; and heads of width 6 and 3 (the
# stage's general body: a k-loop of bf16 mma steps with the columns past a
# head zeroed, f32 FMAs in fours and one at a time) at N = 65 and 100
TILE_PAIR = [(B, N) for B in (1, 3, 8) for N in (65, 97, 100, 361)]
TILE_PAIR_HEADS = [(B, N, 8) for B, N in TILE_PAIR] + [
    (B, N, ds) for B, N in ((1, 65), (3, 100)) for ds in (6, 3)]


def _bf16_scores_tol(q, k, H, O):
    """gmh_scores in bf16, kernel vs plain, element by element: one bf16 ulp
    of each head sum over sqrt(O), averaged over heads and symmetrised, plus
    1e-5 (chip_smoke.py bf16_scores_tol)."""
    B, C, N, _ = q.shape
    s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, -1),
                     k.reshape(B, C, N, H, -1))
    ulp = torch.exp2(torch.floor(torch.log2(s.abs().clamp_min(1e-30))) - 7)
    b = ulp.mean(dim=2) / math.sqrt(O)
    return 1e-5 + ((b + b.transpose(-1, -2)) / 2).permute(0, 2, 3, 1)


def _grid_adj(B, C, N, g, dev):
    """A symmetric 0/1 adjacency of mean degree 4, as grid's graphs have:
    at N = 361 a row of 361 uniform entries sums to ~180 and one of
    standard-normal entries to near zero as often as not, where two f32
    orders of one sum differ by more than the tolerance."""
    return _sym((torch.rand(B, C, N, N, device=dev, generator=g) < 4 / N).float())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("C,Fi", [(2, 5), (8, 32)])
@pytest.mark.parametrize("B,N,ds", TILE_PAIR_HEADS)
def test_tiled_gmh_kernel_matches_plain_on_card(cuda, B, N, ds, C, Fi, layout):
    """Above N = 64 the wrapper launches gcn_degrees, gmh_projection and the
    tile-pair scores once each; V, the maps and the projection's own
    outputs within rtol = atol = 1e-5 of the plain versions, the maps
    exactly symmetric, a second call bit for bit the first.  C and F_in of
    grid's first and later layers, four heads of width ds; the adjacency
    contiguous (a first layer's) and channels-last (a later one's)."""
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees_plain
    from ccsd_tpu_torch.kernels.gmh_attention import (
        gmh_attention,
        gmh_attention_plain,
        gmh_projection,
        gmh_projection_plain,
    )

    A = O = 4 * ds
    g = torch.Generator(device=cuda).manual_seed(N + C)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    x = r(B, N, Fi)
    adj = _grid_adj(B, C, N, g, cuda)
    if layout == "channels-last":
        adj = adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    w = [r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, O), r(C, O)]
    before = dict(LAUNCHES)
    out = gmh_attention(x, adj, *w, 4, O)
    torch.cuda.synchronize()
    moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    assert moved == {"gcn_degrees": 1, "gmh_projection": 1, "gmh_attention": 1}
    again = gmh_attention(x, adj, *w, 4, O)
    for o, rr, o2 in zip(out, gmh_attention_plain(x, adj, *w, 4, O), again):
        torch.testing.assert_close(o, rr, rtol=1e-5, atol=1e-5)
        assert torch.equal(o, o2)
    assert torch.equal(out[1], out[1].transpose(1, 2))
    deg = gcn_degrees_plain(adj)
    for o, rr in zip(gmh_projection(x, adj, deg, *w), gmh_projection_plain(x, adj, deg, *w)):
        torch.testing.assert_close(o, rr, rtol=1e-5, atol=1e-5)


def _layout(adj, layout):
    """adj (B, C, N, N) contiguous, as the channels-last view a later layer
    passes, or folded to (B, C*N, N)."""
    B, C, N, _ = adj.shape
    if layout == "channels-last":
        return adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    return adj.view(B, C * N, N) if layout == "folded" else adj


# the aggregation tile's edges above N = 64: C = 3 (no whole group of four
# channels), F = 11 (not a multiple of the eight features of an mma), F = 40
# (two passes of features), C = 12 (groups of four channels)
@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("C,F", [(3, 11), (8, 11), (3, 40), (12, 32)])
@pytest.mark.parametrize("B,N", TILED)
def test_tiled_channel_agg_edges_on_card(cuda, B, N, C, F, layout):
    """channel_agg above N = 64 within rtol = atol = 1e-5 of the plain
    version, and bit for bit the same on a second call."""
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain

    g = torch.Generator(device=cuda).manual_seed(N + C + F)
    adj = _layout(_sym(torch.rand(B, C, N, N, device=cuda, generator=g)), layout)
    x = torch.randn(B, N, F, device=cuda, generator=g)
    out = channel_agg(adj, x)
    again = channel_agg(adj, x)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, channel_agg_plain(adj, x), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("layout", ["folded", "channels-last"])
@pytest.mark.parametrize("C,F", [(2, 5), (8, 32), (3, 11)])
def test_tiled_channel_agg_folded_and_bf16_at_n100(cuda, C, F, layout, bf16):
    """At N = 100 (three tiles of 32 rows and one of 4 in the parent's
    tiling; six of 16 and one of 4 here): the folded (B, C*N, N) form and
    the bf16 variant, f32 within 1e-5, bf16 within _bf16_agg_tol, both bit
    for bit on a second call."""
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain

    B, N = 3, 100
    g = torch.Generator(device=cuda).manual_seed(C + F)
    adj = _layout(_sym(torch.rand(B, C, N, N, device=cuda, generator=g)), layout)
    x = torch.randn(B, N, F, device=cuda, generator=g)
    out = channel_agg(adj, x, bf16=bf16)
    again = channel_agg(adj, x, bf16=bf16)
    torch.cuda.synchronize()
    ref = channel_agg_plain(adj, x, bf16=bf16)
    if bf16:
        err = (out - ref).abs()
        assert bool((err <= _bf16_agg_tol(adj, x)).all()), f"max error {err.max().item():.3e}"
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "channels-last"])
@pytest.mark.parametrize("add_loop,loop", [(True, 1.0), (True, 2.0), (False, 1.0)])
@pytest.mark.parametrize("C,Fi", [(3, 11), (8, 11), (4, 40)])
@pytest.mark.parametrize("B,N", TILED)
def test_tiled_projection_edges_on_card(cuda, B, N, C, Fi, add_loop, loop, layout):
    """gmh_projection above N = 64 on the degrees gcn_degrees gives, with
    and without the loop and at loop 2: Q | K and V within rtol = atol =
    1e-5 of the plain version, and bit for bit the same on a second call."""
    from ccsd_tpu_torch.kernels.gcn import gcn_degrees
    from ccsd_tpu_torch.kernels.gmh_attention import gmh_projection, gmh_projection_plain

    A = O = 32
    g = torch.Generator(device=cuda).manual_seed(N + C + Fi)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    x = r(B, N, Fi)
    adj = _layout(_grid_adj(B, C, N, g, cuda), layout)
    w = [r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, O), r(C, O)]
    deg = gcn_degrees(adj, add_loop, loop)
    out = gmh_projection(x, adj, deg, *w, loop, add_loop)
    again = gmh_projection(x, adj, deg, *w, loop, add_loop)
    torch.cuda.synchronize()
    for o, rr, o2 in zip(out, gmh_projection_plain(x, adj, deg, *w, loop, add_loop), again):
        torch.testing.assert_close(o, rr, rtol=1e-5, atol=1e-5)
        assert torch.equal(o, o2)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("B,N,ds", TILE_PAIR_HEADS)
def test_tiled_gmh_scores_kernel_matches_plain_on_card(cuda, B, N, ds, C, bf16):
    """One tile-pair launch; Q and K strided column blocks of one
    projection, as the fused layer hands them over.  f32 within 1e-5;
    bf16 within one bf16 ulp of each head sum over sqrt(O), element by
    element, plus 1e-5; the map exactly symmetric, a second call bit for
    bit the first."""
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

    H = 4
    A = O = H * ds
    g = torch.Generator(device=cuda).manual_seed(N * 10 + C)
    qkv = torch.randn(C, B, N, 2 * A + O, device=cuda, generator=g).transpose(0, 1)
    q, k = qkv[..., :A], qkv[..., A:2 * A]
    before = dict(LAUNCHES)
    out = gmh_scores(q, k, H, O, bf16=bf16)
    torch.cuda.synchronize()
    assert LAUNCHES["gmh_scores"] == before["gmh_scores"] + 1
    ref = gmh_scores_plain(q, k, H, O, bf16=bf16)
    tol = _bf16_scores_tol(q, k, H, O) if bf16 else torch.full_like(ref, 1e-5)
    err = (out - ref).abs()
    assert bool((err <= tol).all()), f"max error {err.max().item():.3e}"
    assert torch.equal(out, out.transpose(1, 2))
    assert torch.equal(out, gmh_scores(q, k, H, O, bf16=bf16))


# N of the tiled designs: one tile past the one-block limit, a multiple of
# the tile, ragged last tiles (of 4 and 9 rows) and grid's N
SCHEDULE_N = [65, 96, 100, 361]


@pytest.mark.parametrize("N", SCHEDULE_N)
def test_tile_pair_schedule_writes_every_entry_once(N):
    """The tile-pair stage's schedule, as csrc/gmh_common.cuh
    tiled_scores_kernel maps it: over the plan's pairs, warp w takes the
    16 x 8 sub-tile at rows 16 (w // 4), columns 8 (w % 4) of (I, J), lane
    (g, t) the entries (g + 8 i, 2 t + j) of it; a lane keeps an entry
    inside both tiles (on a diagonal pair, n <= m), writes (n, m) and, off
    the diagonal n == m, (m, n).  Every entry of the N x N map is written
    exactly once, no kept entry lies in a warp the kernel skips (a warp
    wholly past a ragged tile's end or below a diagonal pair's diagonal
    takes no tanh), and each entry n <= m is kept once."""
    from ccsd_tpu_torch.kernels.gmh_attention import TILE, tile_pairs

    writes = np.zeros((N, N), np.int64)
    kept = 0
    w, g, t, i, j = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), np.arange(2),
                                np.arange(2), indexing="ij")
    n0, m0 = 16 * (w // 4), 8 * (w % 4)
    n, m = n0 + g + 8 * i, m0 + 2 * t + j
    for I, J in tile_pairs(N).tolist():
        nI, nJ = min(TILE, N - I * TILE), min(TILE, N - J * TILE)
        off_diag = I != J
        active = (n0 < nI) & (m0 < nJ) & (off_diag | (n0 <= m0 + 7))
        valid = (n < nI) & (m < nJ) & (off_diag | (n <= m))
        assert not (valid & ~active).any()
        rows, cols = I * TILE + n[valid], J * TILE + m[valid]
        np.add.at(writes, (rows, cols), 1)
        off = rows != cols
        np.add.at(writes, (cols[off], rows[off]), 1)
        kept += int(valid.sum())
    assert (writes == 1).all()
    assert kept == N * (N + 1) // 2


@pytest.mark.parametrize("N", [65, 100, 361, 512, 513])
def test_gcn_row_plan_covers_each_row_once(N):
    """gcn_aggregate's row tiles above N = 64, as csrc/gcn_aggregate.cu
    takes them (block x: rows r0 = rows x .., the last ragged): at most 32
    rows a tile and at most 16 tiles while that allows (17 of 32 rows at
    N = 513), covering the graph's rows once in order; at grid's N = 361,
    16 tiles of 23 rows (128 blocks at B = 8 on the H100's 132 SMs)."""
    from ccsd_tpu_torch.kernels.gcn import MAX_ROW_TILES, ROW_TILE, gcn_rows, row_tiles

    rows = gcn_rows(N)
    tiles = row_tiles(N, rows)
    assert 1 <= rows <= ROW_TILE and rows < N
    assert len(tiles) <= MAX_ROW_TILES if N <= 512 else len(tiles) == 17
    cover = np.zeros(N, np.int64)
    for k, (r0, nr) in enumerate(tiles):
        assert r0 == k * rows and 1 <= nr <= rows
        cover[r0:r0 + nr] += 1
    assert (cover == 1).all() and tiles[-1][0] + tiles[-1][1] == N
    if N == 361:
        assert (rows, len(tiles)) == (23, 16)


@pytest.mark.parametrize("N", [49, 65, 100, 361])
def test_tile_pair_plan_writes_every_entry_once(N):
    """The wrapper's plan of a tiled launch: every pair of tiles I <= J
    once, and the entries its blocks write (rows of I x columns of J, and
    off the diagonal rows of J x columns of I, cut at N) cover the N x N
    map exactly once."""
    from ccsd_tpu_torch.kernels.gmh_attention import TILE, tile_pairs

    plan = tile_pairs(N)
    nt = -(-N // TILE)
    assert plan.dtype == np.int32 and plan.shape == (nt * (nt + 1) // 2, 2)
    assert sorted(map(tuple, plan.tolist())) == [(i, j) for i in range(nt)
                                                for j in range(i, nt)]
    writes = np.zeros((N, N), np.int64)
    for i, j in plan.tolist():
        rows, cols = slice(i * TILE, (i + 1) * TILE), slice(j * TILE, (j + 1) * TILE)
        writes[rows, cols] += 1
        if i != j:
            writes[cols, rows] += 1
    assert (writes == 1).all()


@pytest.mark.parametrize("C,G", [(1, 1), (2, 2), (3, 3), (4, 4), (8, 8), (10, 5),
                                 (12, 4), (16, 8), (17, 6)])
def test_aggregation_tile_channel_groups(C, G):
    """Groups of 8 or 4 channels where they divide C (whole 16-byte copies
    of a channels-last adjacency), else the least equal split into at most
    8 a group."""
    from ccsd_tpu_torch.kernels.gcn import agg_group

    assert agg_group(C) == G


@pytest.mark.parametrize("C", [1, 2, 3, 8])
@pytest.mark.parametrize("N", [65, 100, 361])
def test_aggregation_tile_plan_covers_each_row_and_channel_once(N, C):
    """The blocks of an aggregation-tile launch over one graph, as
    csrc/agg_tile.cuh maps them (row tile r0 = AGG_ROWS blockIdx.y, the last
    ragged; channel group c0 = G blockIdx.x, the last short), take every
    (row, channel) once."""
    from ccsd_tpu_torch.kernels.gcn import AGG_MAX_GROUP, AGG_ROWS, agg_group

    G = agg_group(C)
    assert 1 <= G <= min(C, AGG_MAX_GROUP)
    cover = np.zeros((N, C), np.int64)
    for y in range(-(-N // AGG_ROWS)):
        for x in range(-(-C // G)):
            r0, c0 = AGG_ROWS * y, G * x
            nr, nch = min(AGG_ROWS, N - r0), min(G, C - c0)
            assert 1 <= nr <= AGG_ROWS and 1 <= nch <= G
            cover[r0:r0 + nr, c0:c0 + nch] += 1
    assert (cover == 1).all()


def test_tiled_attention_raises_naming_n_past_what_it_holds():
    """The projection holds the degrees of a channel's N rows in one block:
    past that the geometry raises, naming N, on the host, before any kernel
    is built."""
    from ccsd_tpu_torch.kernels.build import SMEM_LIMIT
    from ccsd_tpu_torch.kernels.gmh_attention import projection_group

    N = SMEM_LIMIT // 4 + 1
    with pytest.raises(ValueError, match=f"N={N}"):
        projection_group(8, N, 32, 32, 32)


def _graph_configs():
    """(name, data, model) of every config/*.yaml with graph model widths."""
    from ccsd_tpu_torch.utils.config import load_yaml

    out = []
    for name in sorted(os.listdir(os.path.join(ROOT, "config"))):
        with open(os.path.join(ROOT, "config", name)) as f:
            cfg = load_yaml(f.read())
        if cfg.get("model", {}).get("adim") and cfg.get("data", {}).get("max_node_num"):
            out.append((name[: -len(".yaml")], cfg["data"], cfg["model"]))
    return out


def _layer_shapes(data, model):
    """(C, F_in, attn, F_out, heads) of a config's AttentionLayers (first
    and later, as models/score_a.py builds them)."""
    from ccsd_tpu_torch.kernels.gmh_attention import head_split

    out = []
    for C, Fi, A in ((model["c_init"], data["max_feat_num"], model["nhid"]),
                     (model["c_hid"], model["nhid"], model["adim"])):
        out.append((C, Fi, A, model["nhid"], head_split(A, model["num_heads"])[0]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _, _ in _graph_configs()])
def test_launch_geometry_fits_every_graph_config(cuda, name):
    """Every kernel's block fits the card's shared memory for every layer
    of every graph config (the graph widths of the CC configs included):
    gcn_aggregate for each ScoreNetworkX layer and channel_agg for each
    AttentionLayer at every N, grid's 361 included; the two attention
    kernels at the config's batch and at 1: their one-block designs where
    N <= 64, their tiled designs (the projection, the tile-pair scores of
    both libraries) above.  The
    shared-memory layouts live only in the CUDA sources, so their libraries
    are asked."""
    from ccsd_tpu_torch.kernels.build import SMEM_LIMIT, kernel_fn
    from ccsd_tpu_torch.kernels.channel_agg import agg_smem
    from ccsd_tpu_torch.kernels.gcn import gcn_aggregate_smem
    from ccsd_tpu_torch.kernels.gmh_attention import (
        MAX_N,
        attention_smem,
        projection_group,
        tiled_scores_group,
    )
    from ccsd_tpu_torch.kernels.gmh_scores import scores_group

    _, data, model = next(c for c in _graph_configs() if c[0] == name)
    N, F, nhid = data["max_node_num"], data["max_feat_num"], model["nhid"]
    for Fi in (F, nhid):
        assert 0 < gcn_aggregate_smem(N, Fi, nhid) <= SMEM_LIMIT, (N, Fi, nhid)
    smem = kernel_fn("gmh_scores", "gmh_scores_smem")
    for C, Fi, A, O, H in _layer_shapes(data, model):
        assert 0 < agg_smem(N, C, Fi) <= SMEM_LIMIT, (C, N, Fi)
        if N > MAX_N:  # the tiled designs
            G = projection_group(C, N, Fi, A, O)
            assert 1 <= G <= C and 0 < kernel_fn(
                "gmh_attention", "gmh_projection_smem")(N, Fi, A, O, G) <= SMEM_LIMIT
            for B in (data["batch_size"], 1):
                for kern in ("gmh_scores", "gmh_attention"):
                    G = tiled_scores_group(kern, B, C, N, A)
                    assert 1 <= G <= C and 0 < kernel_fn(kern, "gmh_tiled_scores_smem")(
                        A, G) <= SMEM_LIMIT, (kern, B, C, N, A, G)
            continue
        assert 0 < attention_smem(N, Fi, A, O, H) <= SMEM_LIMIT, (C, N, Fi, A)
        for B in (data["batch_size"], 1):
            for bf16 in (False, True):
                G = scores_group(B, C, N, A, H, bf16)
                assert 1 <= G <= C and 0 < smem(N, A, H, G, int(bf16)) <= SMEM_LIMIT, (
                    B, C, N, A, bf16, G)


def test_launch_geometry_raises_for_grid_naming_n():
    """grid (N = 361) needs a tiled design of the attention kernels: both
    wrappers' geometry raises, on the host, before any kernel is built."""
    from ccsd_tpu_torch.kernels.gmh_attention import attention_smem
    from ccsd_tpu_torch.kernels.gmh_scores import scores_group

    _, data, model = next(c for c in _graph_configs() if c[0] == "grid")
    N = data["max_node_num"]
    assert N == 361
    C, Fi, A, O, H = _layer_shapes(data, model)[1]
    with pytest.raises(ValueError, match="N=361"):
        attention_smem(N, Fi, A, O, H)
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="N=361"):
            scores_group(data["batch_size"], C, N, A, H, bf16)


@pytest.mark.parametrize("N,rows", [(9, 9), (20, 20), (49, 49), (64, 64), (65, 32), (361, 32)])
def test_row_tiles_only_above_a_whole_graph_block(N, rows):
    """The normalising kernels take a whole graph a block up to N = 64, so
    the degree pass never runs on the sampler's N = 20; grid's N = 361 is
    cut into blocks of 32 rows, which read the degree pass."""
    from ccsd_tpu_torch.kernels.gcn import rows_per_block

    assert rows_per_block(N) == rows


def test_degree_wrapper_routes_cpu_to_plain_at_grid_size():
    """On the CPU every wrapper of the grid path takes its plain version
    (no launch counted), whatever N: no wrapper raises at N = 361."""
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain
    from ccsd_tpu_torch.kernels.gcn import (
        gcn_aggregate,
        gcn_aggregate_plain,
        gcn_degrees,
        gcn_degrees_plain,
    )

    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.random(s).astype(np.float32))  # noqa: E731
    adj, x, w = _sym(t(1, 2, 361, 361)), t(1, 361, 5), t(5, 8)
    before = dict(LAUNCHES)
    d = gcn_degrees(adj)
    agg = channel_agg(adj, x)
    out = gcn_aggregate(x, adj[:, 0], w)
    assert LAUNCHES == before
    torch.testing.assert_close(d, gcn_degrees_plain(adj), rtol=0, atol=0)
    torch.testing.assert_close(agg, channel_agg_plain(adj, x), rtol=0, atol=0)
    torch.testing.assert_close(out, gcn_aggregate_plain(x, adj[:, 0], w), rtol=0, atol=0)


@pytest.mark.parametrize("B,C,scores", [(128, 8, 4), (128, 2, 1), (8, 8, 1), (1024, 8, 8)])
def test_channel_groups_of_the_sampler_layers(B, C, scores):
    """gmh_scores' channels per block on the H100's 132 SMs, where a block
    of any G fits (as at community_small's N = 20): community_small's
    layers (B = 128), grid_small's (B = 8) and a large batch.  One block an
    SM at least; with enough graphs a block takes all C channels."""
    from ccsd_tpu_torch.kernels.gmh_scores import channel_group

    assert channel_group(B, C, 132, lambda g: True) == scores
    # a block that does not fit halves G further
    assert channel_group(B, C, 132, lambda g: g <= 1) == 1


@pytest.mark.cuda
def test_channel_groups_of_the_sampler_layers_on_card(cuda):
    """The same choice with the kernel's own shared-memory count at
    community_small's widths (N = 20, attn 32, 4 heads)."""
    from ccsd_tpu_torch.kernels.gmh_scores import scores_group

    for B, C, G in [(128, 8, 4), (128, 2, 1), (8, 8, 1), (1024, 8, 8)]:
        for bf16 in (False, True):
            assert scores_group(B, C, 20, 32, 4, bf16, 132) == G


def test_gmh_plain_takes_a_channels_last_adjacency():
    """The wrapper's plain version gives the same result for the
    channels-last view a later layer passes as for its contiguous copy (the
    kernel reads adj through its strides; models/attention.py no longer
    copies it)."""
    from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, gmh_attention_plain

    B, N, Fi, A, O, H, C = 3, 12, 6, 24, 24, 4, 5
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x = t(B, N, Fi)
    cl = t(B, N, N, C)
    cl = cl + cl.transpose(1, 2)
    adj = cl.permute(0, 3, 1, 2)  # (B, C, N, N) view of channels-last storage
    assert not adj.is_contiguous()
    w = [t(C, Fi, A), t(C, A), t(C, Fi, A), t(C, A), t(C, Fi, O), t(C, O)]
    # the CPU's matmul may sum in another order for other strides: f32
    # rounding only, at the port's kernel tolerance
    for got, ref in zip(gmh_attention(x, adj, *w, H, O),
                        gmh_attention_plain(x, adj.contiguous(), *w, H, O)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """The built library's name hashes the source and every header it
    includes, transitively: editing a header changes it, editing an
    unrelated file does not."""
    from ccsd_tpu_torch.kernels import build

    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    name = build._target("k")[1]
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert build._target("k")[1] == name
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    edited = build._target("k")[1]
    assert edited != name
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a, edited\n')
    assert build._target("k")[1] not in (name, edited)
