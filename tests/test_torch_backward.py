"""The backward kernels of the port and their plain versions.

* On the CPU, ``gcn_aggregate_bwd_plain`` and ``gmh_attention_bwd_plain``
  (the gradients written out by hand) against torch autograd of the plain
  forwards, in float64 (rtol = atol = 1e-10: the two differ by rounding
  only); a node with only its loop (row sum exactly 1, where ``jnp.clip``
  passes half the gradient) and rows summing below 1 included.  The JAX
  package's gradients are held to them in tests/test_torch_train_parity.py.
* Tests marked ``cuda`` run each backward kernel against its plain
  version on the card at the training shapes of community_small (B = 80
  train, 20 test; N = 20) and grid_small (N = 49), and the autograd path
  of each wrapper; they skip where there is no CUDA device (decided inside
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
    assert LAUNCHES == before


def test_backward_geometry_raises_above_one_block_naming_n():
    """The backward kernels hold a whole graph (and channel) a block: grid's
    N = 361 raises on the host, before any kernel is built."""
    with pytest.raises(ValueError, match="N=361"):
        gcn_aggregate_bwd_smem(361, 5, 32)
    with pytest.raises(ValueError, match="N=361"):
        attention_bwd_smem(361, 32, 32, 32, 4)


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
    layer of every graph config with N <= 64, by the libraries' own counts;
    above it they raise naming N."""
    from ccsd_tpu_torch.kernels.build import SMEM_LIMIT
    from ccsd_tpu_torch.kernels.gmh_attention import MAX_N, head_split

    _, data, model = next(c for c in _graph_configs() if c[0] == name)
    N, F, nhid = data["max_node_num"], data["max_feat_num"], model["nhid"]
    if N > MAX_N:
        with pytest.raises(ValueError, match=f"N={N}"):
            gcn_aggregate_bwd_smem(N, F, nhid)
        return
    for Fi in (F, nhid):
        assert 0 < gcn_aggregate_bwd_smem(N, Fi, nhid) <= SMEM_LIMIT, (N, Fi)
    for Fi, A in ((F, nhid), (nhid, model["adim"])):
        H = head_split(A, model["num_heads"])[0]
        assert 0 < attention_bwd_smem(N, Fi, A, nhid, H) <= SMEM_LIMIT, (N, Fi, A)


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
    x, adj = trainer._batch(next(iter(trainer.train_loader)))
    with pytest.raises(NotImplementedError, match="channel_agg, gmh_scores"):
        trainer.train_step(x, adj)
