"""The port's CC loss, CC solver steps, CC sampler and the Sampler's CC
evaluation against the JAX package's, on the CPU; and the
``sample.score_dtype`` rule in both modes (bf16 now runs).

Networks and inputs are those of tests/test_torch_cc_models.py (N = 8,
cells of 3: E = 28, K = 56, B = 4, ragged flags).  Noise is shared as in
tests/test_torch_sampler.py: each package's module-level noise functions
and VPSDE prior sampling are fed one numpy sequence, in call order, and the
JAX sampler runs under ``jax.disable_jit()``.  Tolerances: the losses on
the JAX draws rtol = 1e-5 (f32 networks ~1e-6 apart, squared and summed);
one solver step rtol = atol = 1e-5; the 5-step sampler rtol = atol = 1e-4
(the score networks' rounding fed back through the iteration, as the graph
sampler's test); the evaluation exactly (the same host statistics on equal
graphs and CCs).
"""

import json

import networkx as nx
import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

import ccsd_tpu.diffusion.solvers as jsolvers
from ccsd_tpu.data import cc_codec as jcodec
from ccsd_tpu.diffusion import sde as jsde
from ccsd_tpu.diffusion.losses import get_score_fn_cc as jget_score_fn_cc
from ccsd_tpu.diffusion.losses import get_sde_loss_fn_cc as jget_sde_loss_fn_cc
from ccsd_tpu.eval import cc_stats as jcc_stats
from ccsd_tpu.eval import stats as jstats
from ccsd_tpu.ops import masks as jmasks

import ccsd_tpu_torch.diffusion.solvers as psolvers
from ccsd_tpu_torch import cli
from ccsd_tpu_torch.data import cc_codec
from ccsd_tpu_torch.data.loader import community_small_adjs
from ccsd_tpu_torch.diffusion import sde as psde
from ccsd_tpu_torch.diffusion.losses import SDELossCC, get_score_fn_cc
from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
from ccsd_tpu_torch.ops import masks as pmasks
from ccsd_tpu_torch.sampling.sampler import Sampler
from ccsd_tpu_torch.utils.config import AttrDict

from test_torch_cc_models import B, E, JSPEC, K, N, SPEC, _networks, _t, cc_inputs

TOL = dict(rtol=1e-5, atol=1e-5)


def _sdes(kind="VP", steps=1000):
    if kind == "VP":
        return (jsde.VPSDE(N=steps, beta_min=0.1, beta_max=1.0),
                psde.VPSDE(N=steps, beta_min=0.1, beta_max=1.0))
    return (jsde.VESDE(N=steps, sigma_min=0.1, sigma_max=1.0),
            psde.VESDE(N=steps, sigma_min=0.1, sigma_max=1.0))


@pytest.mark.parametrize("kind", ["VP", "VE"])
def test_cc_loss_matches_jax_on_the_jax_draws(kind):
    x, adj, r2, _ = cc_inputs(5)
    r2 = (r2 > 0.5).astype(np.float32)
    nets = [_networks(n, False, seed=i) for i, n in enumerate(("x", "adj", "rank2"))]
    js, ps = _sdes(kind)
    jloss = jget_sde_loss_fn_cc(js, js, js, *[m for m, _, _ in nets], JSPEC, eps=1e-5)
    key = jax.random.PRNGKey(7)
    want = jloss(*[p for _, p, _ in nets], jnp.asarray(x), jnp.asarray(adj),
                 jnp.asarray(r2), key)
    # the JAX loss's draws (ccsd_tpu/diffusion/losses.py:186-205)
    k_t, k_zx, k_zadj, k_zr2 = jax.random.split(key, 4)
    ja = jnp.asarray(adj)
    flags = jmasks.node_flags(ja)
    t = jax.random.uniform(k_t, (B,), dtype=ja.dtype) * (js.T - 1e-5) + 1e-5
    draws = [t, jmasks.gen_noise(k_zx, jnp.asarray(x), flags, sym=False),
             jmasks.gen_noise(k_zadj, ja, flags, sym=True),
             jmasks.gen_noise_rank2(k_zr2, jnp.asarray(r2), JSPEC, flags)]
    loss = SDELossCC(ps, ps, ps, SPEC, eps=1e-5)
    got = loss.losses(*[m for _, _, m in nets], _t(x), _t(adj), _t(r2),
                      *[_t(np.asarray(d)) for d in draws])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)


def test_cc_loss_draws_in_the_jax_order():
    """t, z_x, z_adj, z_rank2 from one generator, the rank-2 noise masked
    by the adjacency's node flags and not symmetrised."""
    x, adj, r2, flags = (_t(a) for a in cc_inputs(6))
    _, ps = _sdes()
    t, zx, za, zr = SDELossCC(ps, ps, ps, SPEC).draw(x, adj, r2,
                                                     torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    torch.rand((B,), generator=g)
    torch.randn(x.shape, generator=g)
    torch.randn(adj.shape, generator=g)
    assert torch.equal(zr, pmasks.mask_rank2(torch.randn(r2.shape, generator=g), SPEC, flags))
    assert t.shape == (B,) and zx.shape == x.shape and za.shape == adj.shape


@pytest.mark.parametrize("step", ["Euler", "Reverse", "Langevin"])
def test_cc_solver_step_on_rank2_matches_jax(monkeypatch, step):
    rng = np.random.default_rng(8)
    v = rng.standard_normal((B, E, K)).astype(np.float32)
    score = rng.standard_normal((B, E, K)).astype(np.float32)
    noise = rng.standard_normal((B, E, K)).astype(np.float32)
    t = np.full(B, 0.41, np.float32)
    js, ps = _sdes(steps=50)
    if step == "Langevin":
        jup = jsolvers._make_corrector("Langevin", "rank2", js, 0.05, 0.7, 1, JSPEC)
        pup = psolvers._make_corrector("Langevin", "rank2", ps, 0.05, 0.7, 1, SPEC)
    else:
        jup = jsolvers._make_predictor(step, "rank2", js, False, JSPEC)
        pup = psolvers._make_predictor(step, "rank2", ps, False, SPEC)
    monkeypatch.setattr(jsolvers, "_noise_for", lambda *a: jnp.asarray(noise))
    monkeypatch.setattr(psolvers, "_noise_for", lambda *a: torch.from_numpy(noise))
    jnew, jmean = jup(jax.random.PRNGKey(0), lambda _: jnp.asarray(score), jnp.asarray(v),
                      None, jnp.asarray(t))
    pnew, pmean = pup(None, lambda _: torch.from_numpy(score), torch.from_numpy(v), None,
                      torch.from_numpy(t))
    np.testing.assert_allclose(pmean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(pnew.numpy(), np.asarray(jnew), **TOL)


def _feed(seq, wrap):
    it = iter(seq)

    def raw(shape):
        z = next(it)
        assert z.shape == tuple(shape)
        return wrap(z)

    return raw


@pytest.mark.parametrize("predictor,corrector,fused", [
    ("Euler", "Langevin", False), ("Euler", "Langevin", True), ("Reverse", "Langevin", False)])
def test_cc_sampler_end_to_end_matches_jax(monkeypatch, predictor, corrector, fused):
    """5 steps of the CC PC sampler, shared weights and noise: the update
    order (x, then A on the pre-update x, then F on the pre-update x and
    A; correctors before predictors) and the masked rank-2 noise."""
    steps, F = 5, 5
    _, _, _, flags = cc_inputs(9)
    shapes = [(B, N, F), (B, N, N), (B, E, K)] + [(B, N, F), (B, N, N), (B, E, K)] * (2 * steps)
    rng = np.random.default_rng(10)
    seq = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    nets = [_networks(n, fused and n == "adj", seed=i)
            for i, n in enumerate(("x", "adj", "rank2"))]
    js, ps = _sdes(steps=steps)
    kw = dict(predictor=predictor, corrector=corrector, snr=0.05, scale_eps=0.7, n_steps=1,
              probability_flow=False, denoise=True, eps=1e-4, is_cc=True)

    jraw = _feed(seq, jnp.asarray)

    def jgen(key, x, fl, sym=True):
        z = jraw(x.shape)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    monkeypatch.setattr(jsolvers, "gen_noise", jgen)
    monkeypatch.setattr(jsolvers, "gen_noise_rank2",
                        lambda key, x, spec, fl: jsolvers.mask_rank2(jraw(x.shape), spec, fl))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling",
                        lambda self, key, shape, dtype=None: jraw(shape))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling_sym",
                        lambda self, key, shape, dtype=None: (
                            lambda z: z + jnp.swapaxes(z, -1, -2))(jnp.triu(jraw(shape), 1)))
    jsampler = jsolvers.get_pc_sampler(js, js, (B, N, F), (B, N, N), sde_rank2=js,
                                       shape_rank2=(B, E, K), spec=JSPEC, **kw)
    with jax.disable_jit():
        jout = jsampler(*[jget_score_fn_cc(js, m, p) for m, p, _ in nets],
                        jnp.asarray(flags), jax.random.PRNGKey(0))

    praw = _feed(seq, torch.from_numpy)

    def pgen(x, fl, sym=True, generator=None):
        z = praw(x.shape)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    monkeypatch.setattr(psolvers, "gen_noise", pgen)
    monkeypatch.setattr(psolvers, "gen_noise_rank2",
                        lambda x, spec, fl, generator=None: psolvers.mask_rank2(
                            praw(x.shape), spec, fl))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling",
                        lambda self, shape, generator=None, device=None: praw(shape))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling_sym",
                        lambda self, shape, generator=None, device=None: (
                            lambda z: z + z.transpose(-1, -2))(torch.triu(praw(shape), 1)))
    psampler = psolvers.get_pc_sampler(ps, ps, (B, N, F), (B, N, N), sde_rank2=ps,
                                       shape_rank2=(B, E, K), spec=SPEC, **kw)
    pout = psampler(*[get_score_fn_cc(ps, m) for _, _, m in nets], torch.from_numpy(flags),
                    None)
    assert pout.n_model_evals == jout.n_model_evals
    for name in ("x", "adj", "rank2"):
        np.testing.assert_allclose(getattr(pout, name).numpy(), np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# ------------------------------------------------------------ the Sampler ---

WORKER_KWARGS = dict(min_node_val=1, max_node_val=1, node_label="weight", min_edge_val=1,
                     max_edge_val=1, edge_label="weight", d_min=3, d_max=3, N=20)
LIFT = dict(lifting_procedure="path_based", lifting_procedure_kwargs="basic")


def _cc_config(N_=20, data="community_small_CC", steps=4, **sample):
    """A community_small_CC config cut to tiny widths (seeded init)."""
    return AttrDict({
        "is_cc": True, "seed": 5,
        "data": {"data": data, "batch_size": 4, "max_node_num": N_, "max_feat_num": 5,
                 "test_split": 0.2, "init": "deg", "min_node_val": 1, "max_node_val": 1,
                 "node_label": "weight", "min_edge_val": 1, "max_edge_val": 1,
                 "edge_label": "weight", "d_min": 3, "d_max": 3,
                 "lifting_procedure": "path_based", "lifting_procedure_kwargs": "basic"},
        "sde": {k: {"type": "VP", "beta_min": 0.1, "beta_max": 1.0, "num_scales": steps}
                for k in ("x", "adj", "rank2")},
        "model": {"x": "ScoreNetworkX", "adj": "ScoreNetworkA_CC", "rank2": "ScoreNetworkF",
                  "conv": "GCN", "num_heads": 2, "depth": 2, "adim": 8, "nhid": 8,
                  "num_layers": 2, "num_linears": 2, "c_init": 2, "c_hid": 4, "c_final": 2,
                  "use_bn": False, "cnum": 2, "num_layers_mlp": 1, "use_hodge_mask": True,
                  "conv_hodge": "HCN", "nhid_h": 4, "num_layers_h": 1, "num_linears_h": 1,
                  "c_hid_h": 2, "c_final_h": 2, "adim_h": 4, "num_heads_h": 2},
        "train": {"name": "tiny", "num_epochs": 2, "save_interval": 2, "print_interval": 1,
                  "reduce_mean": False, "lr": 0.01, "lr_schedule": True, "ema": 0.999,
                  "weight_decay": 1e-4, "grad_norm": 1.0, "lr_decay": 0.999, "eps": 1e-5},
        "sampler": {"predictor": "Euler", "corrector": "Langevin", "snr": 0.05,
                    "scale_eps": 0.7, "n_steps": 1},
        "sample": {"use_ema": False, "noise_removal": True, "probability_flow": False,
                   "eps": 1e-4, "seed": 12, **sample},
    })


@pytest.fixture
def tame_rank2_head(monkeypatch):
    """ScoreNetworkF's last layer × 0.01 after the Sampler loads it: the
    seeded (or 2-epoch) F network's score grows with the cube of the rank-2
    tensor (the H²F channel), and at a few sampler steps it overflows to
    inf within two steps, whose NaN quantizes to 1 everywhere."""
    load = Sampler.load_models

    def tamed(self, *args):
        configt, models, source = load(self, *args)
        if "rank2" in models:
            with torch.no_grad():
                models["rank2"].final.linear.weight.mul_(0.01)
        return configt, models, source

    monkeypatch.setattr(Sampler, "load_models", tamed)


def ring_adjs(num, n_max, seed=0):
    rng = np.random.default_rng(seed)
    out = np.zeros((num, n_max, n_max), np.float32)
    for g in range(num):
        n = int(rng.integers(4, n_max + 1))
        i = np.arange(n)
        out[g, i, (i + 1) % n] = out[g, (i + 1) % n, i] = 1
        out[g, 0, 2] = out[g, 2, 0] = 1  # a chord: paths of 3 become cells
    return out


@pytest.mark.parametrize("seed", [0, 42])
def test_sampler_cc_evaluation_matches_jax(seed):
    """``Sampler.evaluate`` on generated CCs (quantized incidences of
    another seed's graphs with noise and isolated nodes) against the JAX
    sampler's CC evaluation: ``eval_graph_list`` of the 1-skeletons and
    ``eval_CC_list``, on the same CCs and test split."""
    test = community_small_adjs(100, seed)[:20]
    gen_adjs = community_small_adjs(100, seed + 1)[:20]
    test_ccs = cc_codec.convert_graphs_to_CCs(adjs_to_graphs(test), **LIFT, max_nb_nodes=20)
    _, rank2 = cc_codec.ccs_to_tensors(
        cc_codec.convert_graphs_to_CCs(adjs_to_graphs(gen_adjs), **LIFT), 20, 3, 3)
    rng = np.random.default_rng(seed)
    rank2 = np.maximum(rank2, rng.random(rank2.shape) < 0.001).astype(np.float32)
    x = (rng.random((20, 20, 4)) < 0.9).astype(np.float32)  # some nodes without features
    gen = [cc_codec.cc_from_incidence([x[i], gen_adjs[i], rank2[i]], 3, 3) for i in range(20)]
    jgen = [jcodec.cc_from_incidence([x[i], gen_adjs[i], rank2[i]], 3, 3) for i in range(20)]
    jtest_ccs = jcodec.convert_graphs_to_CCs(
        [nx.from_numpy_array(a[:int((a.sum(-1) > 0).sum()), :int((a.sum(-1) > 0).sum())])
         for a in test], **LIFT, max_nb_nodes=20)
    methods, kernels = jstats.load_eval_settings()
    want_mmd = jstats.eval_graph_list(jcodec.convert_CC_to_graphs(jtest_ccs),
                                      jcodec.convert_CC_to_graphs(jgen), methods=methods,
                                      kernels=kernels)
    want_cc = jcc_stats.eval_CC_list(jtest_ccs, jgen, WORKER_KWARGS, cc_nb_eval=1000)
    cfg = _cc_config()
    got = Sampler(cfg, test, test, device="cpu", log=False).evaluate(test, gen_adjs, gen)
    assert got["mmd"] == want_mmd and got["cc_mmd"] == want_cc
    assert len(test_ccs) == len(jtest_ccs)


def test_sampler_cc_runs_and_keeps_its_incidences(tmp_path, tame_rank2_head):
    """The CC Sampler end to end on the CPU at N = 8 (seeded networks, 4
    steps): protocol sizes, masked outputs, the CCs and their scores."""
    adjs = ring_adjs(10, 8)
    cfg = _cc_config(8, steps=4, score_dtype="f32")
    cfg.folder = str(tmp_path)
    res = Sampler(cfg, adjs[2:], adjs[:2], device="cpu", log=False).sample()
    assert res["finite"] and res["adj"].shape == (2, 8, 8) and res["rank2"].shape == (2, 28, 56)
    assert res["rank2"].dtype == np.uint8 and len(res["ccs"]) == 2
    fl = res["flags"][:, SPEC.edge_u] * res["flags"][:, SPEC.edge_v]
    assert not res["rank2"][fl == 0].any()
    assert res["cells_per_cc"] == res["rank2"].any(1).sum(1).mean()
    assert set(res["mmd"]) == {"degree", "cluster", "orbit", "spectral"}
    assert set(res["cc_mmd"]) == {"hodge_laplacian_spectrum", "rank0_distrib",
                                  "rank1_distrib", "rank2_distrib"}
    saved = np.load(tmp_path / "samples" / "community_small_CC" / "samples.npz")
    np.testing.assert_array_equal(saved["rank2"], res["rank2"])


@pytest.mark.parametrize("is_cc,dtype,bf16", [
    (False, "bf16", True), (False, "bfloat16", True), (False, None, False),
    (False, "f32", False), (True, None, True), (True, "bf16", True), (True, "f32", False)])
def test_score_dtype_resolves_as_jax_and_bf16_raises(is_cc, dtype, bf16, tame_rank2_head):
    """``sample.score_dtype``: f32 by default in graph mode, bf16 by
    default for community_small_CC (the JAX package's clearance), an
    explicit value winning; a resolved bf16 now samples with the bf16 score
    networks (it raised before they were ported) and says so in the
    results, with finite f32 outputs."""
    from ccsd_tpu.sampling.sampler import score_dtype_default as jdefault

    sample = {} if dtype is None else {"score_dtype": dtype}
    if is_cc:
        cfg = _cc_config(8, steps=2, **sample)
        adjs = ring_adjs(6, 8)
    else:
        from test_torch_sampler import _tiny_config
        cfg = _tiny_config()
        cfg.sample.update(sample)
        adjs = community_small_adjs(6, 0, max_node_num=20)[:, :8, :8]
    want = "bf16" if bf16 else "f32"
    if dtype is None:
        assert jdefault(is_cc, cfg.data.data) == want
    res = Sampler(cfg, adjs, device="cpu", log=False).sample(2)
    assert res["adj"].shape == (2, 8, 8) and res["finite"]
    assert (res["score_dtype"], res["dtype"]) == (want, "f32")


def test_cli_trains_and_samples_a_cc_config(tmp_path, capsys, tame_rank2_head):
    (tmp_path / "config").mkdir()
    cfg = _cc_config(8, steps=3, score_dtype="f32").to_dict()
    with open(tmp_path / "config" / "tiny_cc.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    np.save(tmp_path / "adjs.npy", ring_adjs(10, 8))
    common = ["--config", "tiny_cc", "--folder", str(tmp_path), "--device", "cpu",
              "--train-adjs", str(tmp_path / "adjs.npy")]
    assert cli.main(["--type", "train", *common]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["epochs"] == 2 and np.isfinite(report["train_loss_rank2"])
    out = tmp_path / "s.npz"
    sample = ["--type", "sample", *common, "--out", str(out), "--ckpt", report["ckpt"]]
    cfg["sample"].pop("score_dtype")  # community_small_CC's default: bf16, which runs
    with open(tmp_path / "config" / "tiny_cc.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    assert cli.main(sample) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["score_dtype"] == "bf16" and report["finite"]
    assert cli.main([*sample, "--score-dtype", "f32"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["samples"] == 2 and report["finite"] and "cells_per_cc" in report
    assert (report["score_dtype"], report["dtype"]) == ("f32", "f32")
    assert set(report["cc_mmd"]) >= {"hodge_laplacian_spectrum"}
    assert np.load(out)["rank2"].shape == (2, 28, 56)
