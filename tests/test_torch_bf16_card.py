"""The bf16 variants of the four forward kernels on the card.

Each kernel takes bf16 tensors (a whole graph a block, N <= 64) and is
held, element by element, to its plain version on the same inputs
(``kernels.gcn.plain_in_f32``: the f32 plain function of the inputs
upcast, rounded to bf16 once) at community_small_CC's layer shapes (B =
128, N = 20) and grid_small's (B = 8, N = 49), in the layouts the paths
give them.  The gate is ``bf16_kernel_tol``: one bf16 ulp of the plain
entry plus 1e-5 of the output's scale; ``gmh_scores`` with its bf16
products (``bf16=True``) adds one bf16 ulp of each head sum over
sqrt(F_out) (both round the sums to bf16, from f32 sums in another
order).  Maps must be exactly symmetric, every call must count one
launch, a bf16 call above N = 64 must raise, and a source nvcc cannot
build must raise.

``cuda``-marked: skipped, with the reason, where there is no CUDA device.
This file imports no JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_bf16_card.py -m cuda --noconftest``.
"""

import math

import pytest
import torch

from ccsd_tpu_torch.kernels import LAUNCHES
from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain
from ccsd_tpu_torch.kernels.gcn import (
    bf16_kernel_tol,
    bf16_ulp,
    gcn_aggregate,
    gcn_aggregate_plain,
    gcn_norm,
    plain_in_f32,
)
from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, gmh_attention_plain
from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

BF = torch.bfloat16
# (B, N): community_small_CC's sampler batch, grid_small's
SIZES = [(128, 20), (8, 49)]
# (C, F_in, layout) of a first and a later AttentionLayer
LAYERS = [(2, 11, "contiguous"), (8, 32, "channels-last")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the bf16 kernels run only on the card)")
    return torch.device("cuda")


def _sym(t):
    t = torch.triu(t, 1)
    return t + t.transpose(-1, -2)


def _channels_last(adj):
    return adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def _adj(B, C, N, layout, g, dev):
    adj = _sym(torch.randn(B, C, N, N, generator=g, device=dev)).to(BF)
    return adj if layout == "contiguous" else _channels_last(adj)


def _check(got, ref, tol, name):
    assert got.dtype == BF and got.shape == ref.shape, name
    diff = (got.float() - ref.float()).abs()
    bad = diff > tol["atol"]
    assert bool(got.isfinite().all()) and not bool(bad.any()), (
        f"{name}: {int(bad.sum())} entries out of bound, max |diff| {diff.max().item():.3e}")


def _launched(name, fn):
    before = LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1, f"{name}: launches {LAUNCHES[name] - before}"
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("Fi", [11, 32, 5])
def test_gcn_aggregate_bf16_matches_plain_on_card(cuda, B, N, Fi):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, N, Fi, generator=g, device=cuda).to(BF)
    adj = _sym(torch.randn(B, N, N, generator=g, device=cuda)).to(BF)
    w = (0.3 * torch.randn(Fi, 32, generator=g, device=cuda)).to(BF)
    b = (0.1 * torch.randn(32, generator=g, device=cuda)).to(BF)
    got = _launched("gcn_aggregate", lambda: gcn_aggregate(x, adj, w, b))
    ref = plain_in_f32(gcn_aggregate_plain, BF, x, adj, w, b)
    _check(got, ref, bf16_kernel_tol(ref), "gcn_aggregate")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("C,Fi,layout", LAYERS)
def test_gmh_attention_bf16_matches_plain_on_card(cuda, B, N, C, Fi, layout):
    g = torch.Generator(device=cuda).manual_seed(1)
    A = O = 32
    x = torch.randn(B, N, Fi, generator=g, device=cuda).to(BF)
    adj = _adj(B, C, N, layout, g, cuda)
    r = lambda *s: (0.3 * torch.randn(*s, generator=g, device=cuda)).to(BF)  # noqa: E731
    w = [r(C, Fi, A), r(C, A), r(C, Fi, A), r(C, A), r(C, Fi, O), r(C, O)]
    v, a = _launched("gmh_attention", lambda: gmh_attention(x, adj, *w, 4, O))
    rv, ra = plain_in_f32(gmh_attention_plain, BF, x, adj, *w, 4, O)
    _check(v, rv, bf16_kernel_tol(rv), "gmh_attention V")
    _check(a, ra, bf16_kernel_tol(ra), "gmh_attention map")
    assert torch.equal(a, a.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("C,F,layout", LAYERS)
@pytest.mark.parametrize("rounded", [False, True], ids=["f32-norm", "bf16-norm"])
def test_channel_agg_bf16_matches_plain_on_card(cuda, B, N, C, F, layout, rounded):
    g = torch.Generator(device=cuda).manual_seed(2)
    adj = _adj(B, C, N, layout, g, cuda).abs()
    x = torch.randn(B, N, F, generator=g, device=cuda).to(BF)
    got = _launched("channel_agg", lambda: channel_agg(adj, x, bf16=rounded))
    ref = plain_in_f32(channel_agg_plain, BF, adj, x, rounded)
    tol = bf16_kernel_tol(ref)
    if rounded:  # each norm element may round to either bf16 neighbour of its value
        tol["atol"] = tol["atol"] + bf16_ulp(gcn_norm(adj.float())) @ x.float().abs()[:, None]
    _check(got, ref, tol, "channel_agg")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", SIZES)
@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("products", [True, False], ids=["bf16-products", "f32-products"])
def test_gmh_scores_bf16_matches_plain_on_card(cuda, B, N, C, products):
    g = torch.Generator(device=cuda).manual_seed(3)
    A, O, H = 32, 32, 4
    qkv = torch.randn(C, B, N, 2 * A + O, generator=g, device=cuda).to(BF).transpose(0, 1)
    q, k = qkv[..., :A], qkv[..., A:2 * A]  # strided views, as the fused layer gives
    got = _launched("gmh_scores", lambda: gmh_scores(q, k, H, O, bf16=products))
    ref = plain_in_f32(gmh_scores_plain, BF, q, k, H, O, products)
    tol = bf16_kernel_tol(ref)
    if products:  # each head sum rounded to bf16 from f32 sums in another order
        s = torch.einsum("bcnhd,bcmhd->bchnm", q.float().reshape(B, C, N, H, -1),
                         k.float().reshape(B, C, N, H, -1))
        b = bf16_ulp(s).mean(dim=2) / math.sqrt(O)
        tol["atol"] = tol["atol"] + ((b + b.transpose(-1, -2)) / 2).permute(0, 2, 3, 1)
    _check(got, ref, tol, "gmh_scores")
    assert torch.equal(got, got.transpose(1, 2))


@pytest.mark.cuda
def test_bf16_above_64_nodes_raises_on_card(cuda):
    N, B = 65, 2
    x = torch.randn(B, N, 5, device=cuda).to(BF)
    adj = _sym(torch.randn(B, N, N, device=cuda)).to(BF)
    w = torch.randn(5, 8, device=cuda).to(BF)
    with pytest.raises(NotImplementedError, match="bf16 above N = 64"):
        gcn_aggregate(x, adj, w)
    with pytest.raises(NotImplementedError, match="bf16 above N = 64"):
        channel_agg(adj[:, None], x)
    q = torch.randn(B, 1, N, 8, device=cuda).to(BF)
    with pytest.raises(NotImplementedError, match="bf16 above N = 64"):
        gmh_scores(q, q, 2, 8)
    ws = [torch.randn(1, 5, 8, device=cuda).to(BF), None] * 3
    with pytest.raises(NotImplementedError, match="bf16 above N = 64"):
        gmh_attention(x, adj[:, None], *ws, 2, 8)


@pytest.mark.cuda
def test_a_failed_build_raises_on_card(cuda, tmp_path):
    from ccsd_tpu_torch.kernels import build

    src = tmp_path / "broken.cu"
    src.write_text('extern "C" int broken() { return undefined_name; }\n')
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.nvcc_parallel({"broken": (str(src), str(tmp_path / "libbroken.so"), [])})
