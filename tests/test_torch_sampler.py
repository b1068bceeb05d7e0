"""The port's SDEs, solver steps and whole sampler against the JAX package.

Inputs and noise come from numpy.  The end-to-end case feeds both packages
one noise sequence by monkeypatching each package's module-level
``gen_noise`` in its solver and its VPSDE prior sampling (the pattern of
tests/diffusion/test_solver_step_parity.py:58-60); the JAX sampler runs
under ``jax.disable_jit()`` so its ``lax.scan`` draws noise step by step.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import networkx as nx
import torch

import ccsd_tpu.diffusion.solvers as jsolvers
from ccsd_tpu.data.loader import init_flags as jinit_flags
from ccsd_tpu.diffusion import sde as jsde
from ccsd_tpu.diffusion.losses import get_score_fn as jget_score_fn
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.utils.config import AttrDict as JAttrDict

import ccsd_tpu_torch.diffusion.solvers as psolvers
from ccsd_tpu_torch.data.loader import community_small_adjs, init_flags
from ccsd_tpu_torch.diffusion import sde as psde
from ccsd_tpu_torch.diffusion.losses import get_score_fn
from ccsd_tpu_torch.models.registry import load_model
from ccsd_tpu_torch.sampling.sampler import Sampler
from ccsd_tpu_torch.utils.config import AttrDict
from ccsd_tpu_torch.utils.from_jax import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(kind, N):
    if kind == "VP":
        return jsde.VPSDE(N=N, beta_min=0.1, beta_max=1.0), psde.VPSDE(
            N=N, beta_min=0.1, beta_max=1.0)
    if kind == "subVP":
        return jsde.subVPSDE(N=N, beta_min=0.1, beta_max=1.0), psde.subVPSDE(
            N=N, beta_min=0.1, beta_max=1.0)
    return jsde.VESDE(N=N, sigma_min=0.1, sigma_max=1.0), psde.VESDE(
        N=N, sigma_min=0.1, sigma_max=1.0)


@pytest.mark.parametrize("N,eps", [(10, 1e-3), (50, 1e-3), (1000, 1e-4), (1000, 1e-3)])
def test_timesteps_and_indices_match_jax(N, eps):
    """torch.linspace and jnp.linspace round differently in the last bit;
    the table index each step reads (truncation of t * (N - 1)) must not."""
    js, ps = _pair("VP", N)
    tj = jnp.linspace(js.T, eps, N)
    tp = torch.linspace(ps.T, eps, N)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=0, atol=2e-7)
    np.testing.assert_array_equal(ps.timestep_of(tp).numpy(),
                                  np.asarray(js.timestep_of(tj)))


def test_timestep_of_truncates_at_boundaries():
    """Exact multiples of 1 / (N - 1) and the values one ulp either side."""
    js, ps = _pair("VP", 1000)
    k = np.arange(0, 1000, 37, dtype=np.float32) / np.float32(999)
    t = np.concatenate([k, np.nextafter(k, 0), np.nextafter(k, 2)]).astype(np.float32)
    np.testing.assert_array_equal(ps.timestep_of(torch.from_numpy(t)).numpy(),
                                  np.asarray(js.timestep_of(jnp.asarray(t))))


@pytest.mark.parametrize("kind", ["VP", "subVP", "VE"])
def test_sde_tables_match_jax(kind):
    js, ps = _pair(kind, 1000)
    t = np.linspace(1.0, 1e-3, 97).astype(np.float32)
    x = np.random.default_rng(0).standard_normal((97, 5, 5)).astype(np.float32)
    tj, tp, xj, xp = jnp.asarray(t), torch.from_numpy(t), jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(ps.marginal_std(tp).numpy(),
                               np.asarray(js.marginal_std(tj)), **TOL)
    np.testing.assert_allclose(ps.alpha_of_t(tp).numpy(),
                               np.asarray(js.alpha_of_t(tj)), **TOL)
    for fp, fj in ((ps.sde, js.sde), (ps.discretize, js.discretize)):
        for a, b in zip(fp(xp, tp), fj(xj, tj)):
            np.testing.assert_allclose(np.broadcast_to(a.numpy(), np.shape(b)),
                                       np.asarray(b), **TOL)


def _fixed(B=4, N=6):
    rng = np.random.default_rng(0)

    def sym(a):
        a = np.triu(a, 1)
        return (a + np.swapaxes(a, -1, -2)).astype(np.float32)

    adj = sym(rng.random((B, N, N)))
    score = sym(rng.standard_normal((B, N, N)))
    noise = sym(rng.standard_normal((B, N, N)))
    return adj, score, noise, np.full(B, 0.37, np.float32)


@pytest.mark.parametrize("kind", ["VP", "VE"])
@pytest.mark.parametrize("step", ["Euler", "Reverse", "Langevin"])
def test_solver_step_matches_jax(monkeypatch, kind, step):
    adj, score, noise, t = _fixed()
    js, ps = _pair(kind, 50)
    if step == "Langevin":
        jup = jsolvers._make_corrector("Langevin", "adj", js, 0.05, 0.7, 1, None)
        pup = psolvers._make_corrector("Langevin", "adj", ps, 0.05, 0.7, 1)
    else:
        jup = jsolvers._make_predictor(step, "adj", js, False, None)
        pup = psolvers._make_predictor(step, "adj", ps, False)
    monkeypatch.setattr(jsolvers, "_noise_for", lambda *a: jnp.asarray(noise))
    monkeypatch.setattr(psolvers, "_noise_for", lambda *a: torch.from_numpy(noise))
    jnew, jmean = jup(jax.random.PRNGKey(0), lambda v: jnp.asarray(score),
                      jnp.asarray(adj), None, jnp.asarray(t))
    pnew, pmean = pup(None, lambda v: torch.from_numpy(score),
                      torch.from_numpy(adj), None, torch.from_numpy(t))
    np.testing.assert_allclose(pmean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(pnew.numpy(), np.asarray(jnew), **TOL)


def test_langevin_norms_accumulate_in_f32():
    v = torch.full((2, 3, 3), 0.1, dtype=torch.bfloat16)
    assert psolvers._batch_norm_mean(v).dtype == torch.float32


# a small graph model pair: ScoreNetworkX (2 GCN layers) and ScoreNetworkA
# (3 AttentionLayers), on B=4 graphs of N=8 nodes with F=5 features
B, N, F = 4, 8, 5
DEF_X = {"model_type": "ScoreNetworkX", "max_feat_num": F, "depth": 2,
         "nhid": 8, "use_bn": False, "is_cc": False}
DEF_A = {"model_type": "ScoreNetworkA", "max_feat_num": F, "max_node_num": N,
         "nhid": 8, "num_layers": 3, "num_linears": 2, "c_init": 2, "c_hid": 4,
         "c_final": 2, "adim": 8, "num_heads": 2, "conv": "GCN",
         "use_bn": False, "is_cc": False}


def _noise_feed(seq, wrap):
    it = iter(seq)

    def raw(shape):
        z = next(it)
        assert z.shape == tuple(shape)
        return wrap(z)

    return raw


class _Compiled:
    """A JAX model whose apply runs compiled even inside
    ``jax.disable_jit()``, as it runs in the JAX samplers: XLA then rounds
    a bf16 expression where the port does (tests/test_torch_fused_models.py)."""

    def __init__(self, model):
        self._fn = jax.jit(lambda p, x, a, f: model.apply(p, x, a, flags=f))

    def apply(self, params, x, adj, flags=None):
        with jax.disable_jit(False):
            return self._fn(params, x, adj, flags)


def _sampler_outputs(monkeypatch, predictor, corrector, defs, steps, compiled=False,
                     adj_head_scale=1.0):
    """(JAX, port) sampler outputs for shared weights and noise.  The
    adjacency network's last layer is scaled by ``adj_head_scale`` in both."""
    rng = np.random.default_rng(11)
    shapes = [(B, N, F), (B, N, N)] + [(B, N, F), (B, N, N)] * (
        steps * (2 if corrector == "Langevin" else 1))
    seq = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    flags = np.ones((B, N), np.float32)
    flags[0, 6:] = 0
    flags[2, 5:] = 0

    jx, ja = jload_model(defs[0]), jload_model(defs[1])
    px_, pa_ = jx.init(jax.random.PRNGKey(1)), ja.init(jax.random.PRNGKey(2))
    pa_["final"]["linears"][-1]["w"] = pa_["final"]["linears"][-1]["w"] * adj_head_scale
    js = jsde.VPSDE(N=steps, beta_min=0.1, beta_max=1.0)
    ps = psde.VPSDE(N=steps, beta_min=0.1, beta_max=1.0)
    kw = dict(predictor=predictor, corrector=corrector, snr=0.05, scale_eps=0.7,
              n_steps=1, probability_flow=False, denoise=True, eps=1e-4)

    # JAX: noise from the shared sequence, in call order
    jraw = _noise_feed(seq, jnp.asarray)

    def jgen(key, x, fl, sym=True):
        z = jraw(x.shape)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    monkeypatch.setattr(jsolvers, "gen_noise", jgen)
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling",
                        lambda self, key, shape, dtype=None: jraw(shape))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling_sym",
                        lambda self, key, shape, dtype=None: (
                            lambda z: z + jnp.swapaxes(z, -1, -2))(
                                jnp.triu(jraw(shape), 1)))
    jsampler = jsolvers.get_pc_sampler(js, js, (B, N, F), (B, N, N), **kw)
    wrap = _Compiled if compiled else (lambda m: m)
    with jax.disable_jit():
        jout = jsampler(jget_score_fn(js, wrap(jx), px_),
                        jget_score_fn(js, wrap(ja), pa_),
                        jnp.asarray(flags), jax.random.PRNGKey(0))

    praw = _noise_feed(seq, torch.from_numpy)

    def pgen(x, fl, sym=True, generator=None):
        z = praw(x.shape)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    monkeypatch.setattr(psolvers, "gen_noise", pgen)
    monkeypatch.setattr(psde.VPSDE, "prior_sampling",
                        lambda self, shape, generator=None, device=None: praw(shape))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling_sym",
                        lambda self, shape, generator=None, device=None: (
                            lambda z: z + z.transpose(-1, -2))(
                                torch.triu(praw(shape), 1)))
    mx = load_jax_params(load_model(defs[0]), px_)
    ma = load_jax_params(load_model(defs[1]), pa_)
    psampler = psolvers.get_pc_sampler(ps, ps, (B, N, F), (B, N, N), **kw)
    pout = psampler(get_score_fn(ps, mx), get_score_fn(ps, ma),
                    torch.from_numpy(flags), None)
    assert pout.n_model_evals == jout.n_model_evals
    return jout, pout


@pytest.mark.parametrize("predictor,corrector",
                         [("Euler", "Langevin"), ("Reverse", "None")])
def test_sampler_end_to_end_matches_jax(monkeypatch, predictor, corrector):
    """10-step sampler, shared weights and noise.  Tolerance rtol = atol =
    1e-4: the f32 rounding differences of the 40 score evaluations feed
    back through the iteration (measured on the CPU: max |diff| 7.4e-6 for
    Euler + Langevin)."""
    jout, pout = _sampler_outputs(monkeypatch, predictor, corrector,
                                  (DEF_X, DEF_A), steps=10)
    for name in ("x", "adj"):
        np.testing.assert_allclose(getattr(pout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("fast", [False, True], ids=["fused_f32", "fused_fast"])
def test_fused_sampler_end_to_end_matches_jax(monkeypatch, fast):
    """The sampler on the defs both packages' samplers build by default
    (``with_fused``: fused, and with fast bf16 scores and the blocksum
    final layer), 10 Euler + Langevin steps, shared weights and noise, the
    JAX models compiled.  The adjacency network's last layer is scaled by
    0.01 in both, as chip_smoke.py does for seeded weights: at full scale
    these untrained weights grow the adjacency to ~1e5 within 5 steps, where
    one head sum rounding to the other bf16 neighbour moves the output by
    more than any tolerance.  rtol = atol = 1e-4, as above (measured: max
    |diff| 6.7e-5 fast, 4.3e-6 f32)."""
    defs = (DEF_X, jwith_fused({"adj": DEF_A}, True, fast=fast)["adj"])
    assert defs[1]["fused"] and ("scores_impl" in defs[1]) == fast
    jout, pout = _sampler_outputs(monkeypatch, "Euler", "Langevin", defs, steps=10,
                                  compiled=True, adj_head_scale=0.01)
    for name in ("x", "adj"):
        np.testing.assert_allclose(getattr(pout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_init_flags_matches_jax():
    adjs = community_small_adjs(30, 0)
    graphs = [nx.from_numpy_array(a[: int((a.sum(-1) > 0).sum())]
                                  [:, : int((a.sum(-1) > 0).sum())]) for a in adjs]
    cfg = JAttrDict({"data": {"max_node_num": 20, "batch_size": 16}})
    ref = jinit_flags(graphs, cfg, 16, rng=np.random.default_rng(5))
    np.testing.assert_array_equal(
        init_flags(adjs, 16, np.random.default_rng(5)), ref)


def test_community_small_adjs_follow_the_recipe():
    adjs = community_small_adjs(200, 1)
    assert adjs.shape == (200, 20, 20)
    assert np.array_equal(adjs, adjs.transpose(0, 2, 1))
    assert not adjs[:, np.arange(20), np.arange(20)].any()
    sizes = set(init_flags(adjs, 200, np.random.default_rng(2)).sum(-1).astype(int))
    assert sizes <= set(range(1, 21)) and {12, 20} <= sizes


def _tiny_config(seed=3):
    return AttrDict({
        "data": {"data": "tiny", "batch_size": B, "max_node_num": N,
                 "max_feat_num": F, "test_split": 0.2},
        "sde": {k: {"type": "VP", "beta_min": 0.1, "beta_max": 1.0,
                    "num_scales": 4} for k in ("x", "adj")},
        "model": {"x": "ScoreNetworkX", "adj": "ScoreNetworkA", "conv": "GCN",
                  "num_heads": 2, "depth": 2, "adim": 8, "nhid": 8,
                  "num_layers": 3, "num_linears": 2, "c_init": 2, "c_hid": 4,
                  "c_final": 2, "use_bn": False},
        "sampler": {"predictor": "Euler", "corrector": "Langevin", "snr": 0.05,
                    "scale_eps": 0.7, "n_steps": 1},
        "sample": {"use_ema": False, "noise_removal": True,
                   "probability_flow": False, "eps": 1e-4, "seed": 12},
        "seed": seed,
    })


def test_cli_samples_from_a_config_file(tmp_path, capsys):
    import json

    import yaml

    from ccsd_tpu_torch import cli

    (tmp_path / "config").mkdir()
    with open(tmp_path / "config" / "tiny.yaml", "w") as f:
        yaml.safe_dump(_tiny_config().to_dict(), f)
    train = community_small_adjs(10, 0, max_node_num=N + 12)
    np.save(tmp_path / "train.npy", train[:, :N, :N])
    out = tmp_path / "samples.npz"
    assert cli.main(["--type", "sample", "--config", "tiny", "--folder", str(tmp_path),
                     "--device", "cpu", "--num-samples", "5",
                     "--train-adjs", str(tmp_path / "train.npy"), "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["samples"] == 5 and report["device"] == "cpu" and report["finite"]
    got = np.load(out)
    assert got["adj"].shape == (5, N, N) and got["x"].shape == (5, N, F)


def test_cli_sample_draws_node_counts_from_the_train_split(tmp_path):
    """``cli --type sample`` hands the Sampler the train split only (all but
    the first int(test_split * M) graphs): its flags are the JAX
    ``init_flags`` of the train graphs under the same seed, and not those
    of the whole set."""
    import yaml

    from ccsd_tpu_torch import cli

    cfg = _tiny_config()
    (tmp_path / "config").mkdir()
    with open(tmp_path / "config" / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    sizes = [8, 8, 2, 3, 4, 5, 6, 7, 2, 3]  # the test split: the two of 8 nodes
    adjs = np.zeros((len(sizes), N, N), np.float32)
    for a, n in zip(adjs, sizes):  # paths: every node of the graph has an edge
        a[np.arange(n - 1), np.arange(1, n)] = a[np.arange(1, n), np.arange(n - 1)] = 1
    np.save(tmp_path / "adjs.npy", adjs)
    out = tmp_path / "samples.npz"
    assert cli.main(["--type", "sample", "--config", "tiny", "--folder", str(tmp_path),
                     "--device", "cpu", "--num-samples", str(B),
                     "--train-adjs", str(tmp_path / "adjs.npy"), "--out", str(out)]) == 0
    flags = np.load(out)["flags"]
    k = int(cfg.data.test_split * len(sizes))
    graphs = [nx.path_graph(n) for n in sizes]
    seed = int(cfg.sample.seed)
    jcfg = JAttrDict({"data": {"max_node_num": N, "batch_size": B}})
    np.testing.assert_array_equal(
        flags, jinit_flags(graphs[k:], jcfg, B, rng=np.random.default_rng(seed)))
    assert not np.array_equal(flags, init_flags(adjs, B, np.random.default_rng(seed)))


@pytest.mark.parametrize("sample,expect", [
    ({}, (True, "mulreduce_h_bf16", "blocksum")),
    ({"fast": False}, (True, "mulreduce", "concat")),
    ({"fused": False}, (False, "mulreduce", "concat")),
], ids=["default", "fast_false", "fused_false"])
def test_sampler_builds_the_network_the_jax_sampler_builds(sample, expect):
    """sample.fused / sample.fast, both on by default, as in
    ccsd_tpu/sampling/sampler.py:220-223; fused: false is the unfused f32
    network."""
    cfg = _tiny_config()
    for k, v in sample.items():
        cfg.sample[k] = v
    _, models, _ = Sampler(cfg, np.zeros((2, N, N)), device="cpu").load_models()
    net = models["adj"]
    assert {(l.fused, l.scores_impl, l.agg_impl) for l in net.layers} == {
        (*expect[:2], "mulreduce")}
    assert net.final_impl == expect[2]


def test_sampler_on_cpu_returns_valid_graphs():
    train = community_small_adjs(10, 0, max_node_num=N + 12)
    train = train[:, :N, :N]
    res = Sampler(_tiny_config(), train, device="cpu").sample(num_samples=6)
    adj, flags = res["adj"], res["flags"]
    assert adj.shape == (6, N, N) and res["x"].shape == (6, N, F)
    assert np.isfinite(res["x"]).all() and set(np.unique(adj)) <= {0.0, 1.0}
    assert np.array_equal(adj, adj.transpose(0, 2, 1))
    assert not adj[:, np.arange(N), np.arange(N)].any()
    absent = flags == 0
    assert not adj[absent].any() and not res["x"][absent].any()
    assert res["finite"] and res["device"] == "cpu"
    assert res["weights"].startswith("seeded init")
    assert math.isfinite(res["steps_per_s"])
