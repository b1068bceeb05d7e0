"""The two bf16 sampling modes in the port against the JAX package, on the
CPU.

* ``sample.score_dtype: bf16`` (selective precision).  Each network's bf16
  evaluation is held to the JAX package's bf16 evaluation of the same
  weights and inputs by their distance to a float64 copy (the port's
  network, unfused where the path rounds its head scores, in float64):
  the port may lie at most 4× as far from float64 as JAX does (its
  kernels' plain versions sum in f32 and round once, where XLA may round
  more often; the map of the fused bf16-score lowering is rounded to bf16
  once more).  Both distances are printed.  Layers: ``DenseGCNConv``,
  ``AttentionLayer`` unfused and fused; networks through ``get_score_fn``
  / ``get_score_fn_cc`` with ``compute_dtype``: ScoreNetworkX,
  ScoreNetworkA (unfused; fused with the sampler's fast lowerings),
  ScoreNetworkA_CC, ScoreNetworkA_Base_CC, ScoreNetworkF (channel stack and
  slab form).  Graph networks at N = 20 (B = 4, narrow widths), the CC ones
  at tests/test_torch_cc_models.py's N = 8 (E = 28, K = 56).  JAX runs
  compiled, as its sampler does.  The score functions return f32 and
  leave the caller's module in f32; the bf16 copy is made once.
* ``sample.dtype: bf16`` (the carry).  Five steps of the PC sampler in
  graph and CC mode, noise shared with JAX's ``get_pc_sampler(...,
  carry_dtype=jnp.bfloat16)`` as tests/test_torch_sampler.py shares it
  (each draw cast to the carry's dtype, as both packages draw it): the
  score networks see bf16 carries, the outputs are f32, and each output
  agrees with JAX's within 5e-2 of its scale (the JAX package's own bound
  on bf16 scores, tests/diffusion/test_solvers.py:212-232).  The S4 solver
  takes the key and ignores it.
* The resolved ``sample.score_dtype`` of every file in config/ equals the
  JAX sampler's.
"""

import copy
import glob
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

import ccsd_tpu.diffusion.solvers as jsolvers
from ccsd_tpu.diffusion import sde as jsde
from ccsd_tpu.diffusion.losses import get_score_fn as jget_score_fn
from ccsd_tpu.diffusion.losses import get_score_fn_cc as jget_score_fn_cc
from ccsd_tpu.models import attention as jatt
from ccsd_tpu.models import gcn as jgcn
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.models.registry import load_model_params as jload_model_params
from ccsd_tpu.models.registry import with_fused as jwith_fused
from ccsd_tpu.sampling.sampler import score_dtype_default as jscore_dtype_default
from ccsd_tpu.utils.config import get_config as jget_config

import ccsd_tpu_torch.diffusion.solvers as psolvers
from ccsd_tpu_torch.diffusion import sde as psde
from ccsd_tpu_torch.diffusion.losses import get_score_fn, get_score_fn_cc
from ccsd_tpu_torch.models.attention import AttentionLayer
from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.nn import cast_copy
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.sampling.sampler import dtype_name, sample_dtypes
from ccsd_tpu_torch.utils.config import AttrDict, get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params

from test_torch_base_cc import small_base_cc_configs
from test_torch_cc_models import JSPEC, SPEC, _perturb, cc_inputs, small_cc_configs
from test_torch_models import _inputs, _perturb_biases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF = torch.bfloat16
FACTOR = 4.0  # the port's distance from float64 over JAX's, at most
CARRY_TOL = 5e-2  # of each output's scale
SMALL = {"depth": 2, "nhid": 16, "num_layers": 3, "c_init": 2, "c_hid": 4, "c_final": 2,
         "adim": 16, "num_heads": 4}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float64)


def _gate(name, port, jax_out, ref64):
    """The port's and JAX's distances from the float64 copy; the port's at
    most FACTOR times JAX's."""
    port, jax_out, ref = _np(port), np.asarray(jax_out, np.float64), _np(ref64)
    dp, dj = np.abs(port - ref).max(), np.abs(jax_out - ref).max()
    print(f"{name}: distance from float64, port bf16 {dp:.3e}, JAX bf16 {dj:.3e}")
    assert np.isfinite(port).all() and dp <= FACTOR * dj, (name, dp, dj)


def _jax_bf16(fn, *args):
    """fn compiled on args (float arrays cast to bf16), as JAX's
    ``_compute_cast`` casts parameters and inputs."""
    def cast(a):
        return a.astype(jnp.bfloat16) if jnp.issubdtype(a.dtype, jnp.floating) else a

    return jax.jit(lambda *a: fn(*jax.tree.map(cast, a)))(*jax.tree.map(jnp.asarray, args))


def _f64(t):
    return torch.from_numpy(np.asarray(t, np.float64))


def _bf(t):
    return torch.from_numpy(np.asarray(t, np.float32)).to(BF)


# --------------------------------------------------------------- layers ---

def test_dense_gcn_conv_bf16_matches_jax():
    x, adj, flags = _inputs(11, seed=3)
    jm = jgcn.DenseGCNConv(11, 16)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(3)))
    m = load_jax_params(DenseGCNConv(11, 16), p)
    want = _jax_bf16(lambda p, x, a: jm.apply(p, x, a), p, x, adj)
    with torch.no_grad():
        got = cast_copy(m, BF)(_bf(x), _bf(adj))
        ref = copy.deepcopy(m).double()(_f64(x), _f64(adj))
    assert got.dtype == BF and m.weight.dtype == torch.float32
    _gate("DenseGCNConv", got, want, ref)


@pytest.mark.parametrize("fused,scores_impl", [(False, "mulreduce"), (True, "mulreduce"),
                                               (True, "mulreduce_h_bf16")])
def test_attention_layer_bf16_matches_jax(fused, scores_impl):
    dims, kw = (2, 11, 16, 16, 2, 4), dict(num_heads=4, fused=fused, scores_impl=scores_impl)
    jm = jatt.AttentionLayer(*dims, **kw)
    p = _perturb_biases(jm.init(jax.random.PRNGKey(4)))
    m = load_jax_params(AttentionLayer(*dims, **kw), p)
    x, adj, flags = _inputs(11, C=2, seed=4)
    jh, ja = _jax_bf16(lambda p, x, a, f: jm.apply(p, x, a, f), p, x, adj, flags)
    ref64 = load_jax_params(AttentionLayer(*dims, num_heads=4), p).double()
    with torch.no_grad():
        h, a = cast_copy(m, BF)(_bf(x), _bf(adj), _bf(flags))
        rh, ra = ref64(_f64(x), _f64(adj), _f64(flags))
    _gate(f"AttentionLayer {scores_impl} fused={fused} x", h, jh, rh)
    _gate(f"AttentionLayer {scores_impl} fused={fused} adj", a, ja, ra)


# ------------------------------------------------------------- networks ---

def _graph_defs(fused, fast):
    """community_small's (x, adj) definitions at SMALL widths, both
    packages' equal, with the sampler's ``with_fused`` where fused."""
    jcfg, cfg = jget_config("community_small", 0), get_config("community_small", 0)
    for c in (jcfg, cfg):
        for k, v in SMALL.items():
            c.model[k] = v
    jdefs = dict(zip(("x", "adj"), jload_model_params(jcfg)))
    assert dict(zip(("x", "adj"), load_model_params(cfg))) == jdefs
    return jwith_fused(jdefs, fused, fast=fast) if fused else jdefs


def _score_inputs(seed):
    x, adj, flags = _inputs(11, seed=seed)
    rng = np.random.default_rng(seed)
    adj = adj + 0.3 * rng.standard_normal(adj.shape).astype(np.float32)
    adj = ((adj + np.swapaxes(adj, -1, -2)) / 2 * flags[:, :, None] * flags[:, None, :])
    return x, adj.astype(np.float32), flags, np.full(x.shape[0], 0.4, np.float32)


@pytest.mark.parametrize("name,fused,fast", [
    ("x", False, False), ("adj", False, False), ("adj", True, True)],
    ids=["ScoreNetworkX", "ScoreNetworkA", "ScoreNetworkA_fused_fast"])
def test_graph_score_fn_bf16_matches_jax(name, fused, fast):
    defs = _graph_defs(fused, fast)
    jm = jload_model(defs[name])
    p = _perturb_biases(jm.init(jax.random.PRNGKey(6)))
    m = load_jax_params(load_model(defs[name]), p)
    ref64 = load_jax_params(load_model(_graph_defs(False, False)[name]), p).double()
    x, adj, flags, t = _score_inputs(6)
    js, ps = (m(N=1000, beta_min=0.1, beta_max=1.0) for m in (jsde.VPSDE, psde.VPSDE))
    want = jax.jit(jget_score_fn(js, jm, p, compute_dtype=jnp.bfloat16))(
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(flags), jnp.asarray(t))
    fn = get_score_fn(ps, m, BF)
    with torch.no_grad():
        got = fn(*map(torch.from_numpy, (x, adj, flags, t)))
        ref = get_score_fn(ps, ref64)(*map(_f64, (x, adj, flags, t)))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    assert all(q.dtype == torch.float32 for q in m.parameters())
    twin = cast_copy(m, BF)
    assert all(q.dtype == BF and not q.requires_grad for q in twin.parameters())
    assert all(q.dtype == torch.float32 for q in m.parameters())
    _gate(defs[name]["model_type"] + (" fused fast" if fast else ""), got, want, ref)


def _cc_nets(which, fused):
    if which == "Base_CC":
        jcfg, cfg = small_base_cc_configs(2, 1)
        name = "adj"
    else:
        jcfg, cfg = small_cc_configs(1)
        name = which
    i = ("x", "adj", "rank2").index(name)
    jdef, pdef = jload_model_params(jcfg, is_cc=True)[i], load_model_params(cfg)[i]
    assert jdef == pdef
    if fused:
        jdef = jwith_fused({name: jdef})[name]
        assert with_fused({name: pdef})[name] == jdef
    jm = jload_model(jdef)
    p = _perturb(jm.init(jax.random.PRNGKey(8)), 8)
    ref64 = load_jax_params(load_model(pdef), p).double()
    return jm, p, load_jax_params(load_model(jdef), p), ref64


@pytest.mark.parametrize("which,fused", [("adj", False), ("adj", True), ("Base_CC", False),
                                         ("Base_CC", True), ("rank2", False),
                                         ("rank2", True)])
def test_cc_score_fn_bf16_matches_jax(which, fused):
    jm, p, m, ref64 = _cc_nets(which, fused)
    x, adj, r2, flags = cc_inputs(9)
    r2 = r2 * 0.5  # F's H²F channel is cubic in F
    t = np.full(x.shape[0], 0.4, np.float32)
    js, ps = (m(N=1000, beta_min=0.1, beta_max=1.0) for m in (jsde.VPSDE, psde.VPSDE))
    want = jax.jit(jget_score_fn_cc(js, jm, p, compute_dtype=jnp.bfloat16))(
        *map(jnp.asarray, (x, adj, r2, flags, t)))
    with torch.no_grad():
        got = get_score_fn_cc(ps, m, BF)(*map(torch.from_numpy, (x, adj, r2, flags, t)))
        ref = get_score_fn_cc(ps, ref64)(*map(_f64, (x, adj, r2, flags, t)))
    assert got.dtype == torch.float32
    assert all(q.dtype == torch.float32 for q in m.parameters())
    _gate(f"{type(m).__name__} fused={fused}", got, want, ref)


def test_cc_networks_follow_the_carry_dtype():
    """Under the bf16 carry the score function runs the CC networks that
    follow the rank-2 tensor's dtype in JAX (both adjacency networks, F's
    slab form) on a bf16 copy: their score is bf16 while the network stays
    f32.  F's channel-stack form promotes to f32, and a network called
    alone runs in its parameters' dtype."""
    x, adj, r2, flags = cc_inputs(10)
    ps = psde.VPSDE(N=1000, beta_min=0.1, beta_max=1.0)
    t = torch.full((x.shape[0],), 0.4)
    a = (_bf(x), _bf(adj), _bf(r2 * 0.5), torch.from_numpy(flags).to(BF), t)
    for which, fused, want in (("adj", False, BF), ("Base_CC", False, BF), ("rank2", True, BF),
                               ("rank2", False, torch.float32)):
        _, _, m, _ = _cc_nets(which, fused)
        assert getattr(m, "follows_rank2_dtype", False) == (want == BF)
        with torch.no_grad():
            out = get_score_fn_cc(ps, m, carry_dtype=BF)(*a)
            alone = m(*a[:2], rank2=a[2], flags=a[3])
        assert out.dtype == want and alone.dtype == torch.float32, (which, fused)
        assert all(q.dtype == torch.float32 for q in m.parameters())


# ---------------------------------------------------------------- carry ---

def _feed(seq):
    it = iter(seq)

    def raw(shape):
        z = next(it)
        assert z.shape == tuple(shape)
        return z

    return raw


def _patch_noise(monkeypatch, seq):
    """Both packages' noise functions and VPSDE priors fed one numpy
    sequence in call order, each draw cast to the tensor's dtype."""
    jraw, praw = _feed(seq), _feed(seq)

    def jgen(key, x, fl, sym=True):
        z = jnp.asarray(jraw(x.shape)).astype(x.dtype)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    def pgen(x, fl, sym=True, generator=None):
        z = torch.from_numpy(praw(x.shape)).to(x.dtype)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    monkeypatch.setattr(jsolvers, "gen_noise", jgen)
    monkeypatch.setattr(jsolvers, "gen_noise_rank2", lambda key, x, spec, fl: jsolvers.mask_rank2(
        jnp.asarray(jraw(x.shape)).astype(x.dtype), spec, fl))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling",
                        lambda self, key, shape, dtype=None: jnp.asarray(jraw(shape)))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling_sym",
                        lambda self, key, shape, dtype=None: (
                            lambda z: z + jnp.swapaxes(z, -1, -2))(
                                jnp.triu(jnp.asarray(jraw(shape)), 1)))
    monkeypatch.setattr(psolvers, "gen_noise", pgen)
    monkeypatch.setattr(psolvers, "gen_noise_rank2",
                        lambda x, spec, fl, generator=None: psolvers.mask_rank2(
                            torch.from_numpy(praw(x.shape)).to(x.dtype), spec, fl))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling",
                        lambda self, shape, generator=None, device=None: torch.from_numpy(
                            praw(shape)))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling_sym",
                        lambda self, shape, generator=None, device=None: (
                            lambda z: z + z.transpose(-1, -2))(
                                torch.triu(torch.from_numpy(praw(shape)), 1)))


class _Compiled:
    """A JAX score network applied compiled even under ``jax.disable_jit()``,
    as the JAX sampler compiles it (XLA's bf16 rounding points)."""

    def __init__(self, model):
        self._fn = jax.jit(lambda p, *a, flags=None: model.apply(p, *a, flags=flags))

    def apply(self, params, *a, flags=None):
        with jax.disable_jit(False):
            return self._fn(params, *a, flags=flags)


def _recording(fn, seen):
    def run(*a):
        seen.update(str(v.dtype) for v in a[:-2] if v is not None)
        return fn(*a)
    return run


def _close(name, got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and want.dtype == np.float32
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    print(f"carry {name}: max |port - JAX| {err:.3e} of scale {scale:.3e}")
    assert np.isfinite(got).all() and err <= CARRY_TOL * scale, (name, err, scale)


def test_graph_carry_bf16_matches_jax(monkeypatch):
    steps, B, N = 5, 4, 20
    defs = _graph_defs(False, False)
    jms = [jload_model(defs[n]) for n in ("x", "adj")]
    ps_ = [_perturb_biases(m.init(jax.random.PRNGKey(11 + i))) for i, m in enumerate(jms)]
    ps_[1]["final"]["linears"][-1]["w"] = ps_[1]["final"]["linears"][-1]["w"] * 0.1
    pms = [load_jax_params(load_model(defs[n]), p) for n, p in zip(("x", "adj"), ps_)]
    _, _, flags = _inputs(11, seed=12)
    rng = np.random.default_rng(12)
    shapes = [(B, N, 11), (B, N, N)] + [(B, N, 11), (B, N, N)] * (2 * steps)
    _patch_noise(monkeypatch, [rng.standard_normal(s).astype(np.float32) for s in shapes])
    js, ps = (m(N=steps, beta_min=0.1, beta_max=1.0) for m in (jsde.VPSDE, psde.VPSDE))
    kw = dict(predictor="Euler", corrector="Langevin", snr=0.05, scale_eps=0.7, n_steps=1,
              probability_flow=False, denoise=True, eps=1e-4)
    jsampler = jsolvers.get_pc_sampler(js, js, (B, N, 11), (B, N, N),
                                       carry_dtype=jnp.bfloat16, **kw)
    with jax.disable_jit():
        jout = jsampler(*[jget_score_fn(js, _Compiled(m), p) for m, p in zip(jms, ps_)],
                        jnp.asarray(flags), jax.random.PRNGKey(0))
    seen = set()
    psampler = psolvers.get_pc_sampler(ps, ps, (B, N, 11), (B, N, N), carry_dtype=BF, **kw)
    with torch.no_grad():
        pout = psampler(*[_recording(get_score_fn(ps, m), seen) for m in pms],
                        torch.from_numpy(flags), None)
    assert seen == {"torch.bfloat16"}
    for name in ("x", "adj"):
        _close(name, getattr(pout, name), getattr(jout, name))


def test_cc_carry_bf16_matches_jax(monkeypatch):
    steps = 5
    nets = []
    for i, which in enumerate(("x", "adj", "rank2")):
        jm, p, m, _ = _cc_nets(which, which == "rank2")
        if which == "rank2":  # the seeded F overflows a few steps (H²F is cubic)
            p["final"]["linears"][-1]["w"] = p["final"]["linears"][-1]["w"] * 0.01
            m = load_jax_params(m, p)
        nets.append((jm, p, m))
    x, adj, r2, flags = cc_inputs(13)
    B, N, Fx = x.shape
    E, K = SPEC.num_edges, SPEC.num_cells
    rng = np.random.default_rng(13)
    shapes = [(B, N, Fx), (B, N, N), (B, E, K)] + [(B, N, Fx), (B, N, N), (B, E, K)] * (
        2 * steps)
    _patch_noise(monkeypatch, [rng.standard_normal(s).astype(np.float32) for s in shapes])
    js, ps = (m(N=steps, beta_min=0.1, beta_max=1.0) for m in (jsde.VPSDE, psde.VPSDE))
    kw = dict(predictor="Euler", corrector="Langevin", snr=0.05, scale_eps=0.7, n_steps=1,
              probability_flow=False, denoise=True, eps=1e-4, is_cc=True)
    jsampler = jsolvers.get_pc_sampler(js, js, (B, N, Fx), (B, N, N), sde_rank2=js,
                                       shape_rank2=(B, E, K), spec=JSPEC,
                                       carry_dtype=jnp.bfloat16, **kw)
    with jax.disable_jit():
        jout = jsampler(*[jget_score_fn_cc(js, _Compiled(m), p) for m, p, _ in nets],
                        jnp.asarray(flags), jax.random.PRNGKey(0))
    seen = set()
    psampler = psolvers.get_pc_sampler(ps, ps, (B, N, Fx), (B, N, N), sde_rank2=ps,
                                       shape_rank2=(B, E, K), spec=SPEC, carry_dtype=BF, **kw)
    with torch.no_grad():
        pout = psampler(*[_recording(get_score_fn_cc(ps, m, carry_dtype=BF), seen)
                          for _, _, m in nets],
                        torch.from_numpy(flags), None)
    assert seen == {"torch.bfloat16"}
    for name in ("x", "adj", "rank2"):
        _close(name, getattr(pout, name), getattr(jout, name))


def test_s4_solver_takes_the_carry_dtype_and_ignores_it():
    defs = _graph_defs(False, False)
    g = torch.Generator().manual_seed(3)
    ms = [load_model(defs[n], generator=g) for n in ("x", "adj")]
    ps = psde.VPSDE(N=3, beta_min=0.1, beta_max=1.0)
    _, _, flags = _inputs(11, seed=14)
    outs = []
    for carry in (None, BF):
        solver = psolvers.get_s4_solver(ps, ps, (4, 20, 11), (4, 20, 20), carry_dtype=carry)
        with torch.no_grad():
            outs.append(solver(*[get_score_fn(ps, m) for m in ms], torch.from_numpy(flags),
                               torch.Generator().manual_seed(5)))
    for a, b in zip(outs[0][:2], outs[1][:2]):
        assert a.dtype == torch.float32 and torch.equal(a, b)


# ----------------------------------------------------- default resolution ---

def _yaml(path):
    with open(path) as f:
        return yaml.safe_load(f) or {}


# every config of the repo that names a dataset (general_config.yaml does not)
CONFIGS = sorted(p for p in glob.glob(os.path.join(ROOT, "config", "*.yaml"))
                 if "data" in _yaml(p))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_score_dtype_default_matches_jax_for_every_config(path):
    cfg = AttrDict(_yaml(path))
    cfg.setdefault("sample", AttrDict())
    is_cc = bool(cfg.get("is_cc", False))
    want = str(cfg.sample.get("score_dtype",
                              jscore_dtype_default(is_cc, cfg.data.data))).lower()
    want = "bf16" if want in ("bf16", "bfloat16") else "f32"
    got = sample_dtypes(cfg, cfg, is_cc)
    assert dtype_name(got["score_dtype"]) == want and dtype_name(got["dtype"]) == "f32"


def test_sampler_says_when_a_bf16_run_left_f32(monkeypatch, tmp_path):
    """A run whose reverse diffusion leaves f32 says so in its results (and
    so in the CLI's JSON line and the log), naming the bf16 mode it ran."""
    import ccsd_tpu_torch.sampling.sampler as smod
    from test_torch_cc_sampler import _cc_config, ring_adjs

    real = smod.load_sampling_fn

    def overflowing(*a, **kw):
        fn = real(*a, **kw)
        return lambda *b: (lambda out: out._replace(rank2=out.rank2 * float("inf")))(fn(*b))

    monkeypatch.setattr(smod, "load_sampling_fn", overflowing)
    cfg = _cc_config(8, steps=2)  # community_small_CC's default: bf16 scores
    cfg.folder, cfg.sample.eval = str(tmp_path), False
    res = smod.Sampler(cfg, ring_adjs(6, 8), device="cpu", log=False).sample(2)
    assert not res["finite"] and res["score_dtype"] == "bf16"
    assert "left f32" in res["note"] and "sample.score_dtype: bf16" in res["note"]
    monkeypatch.setattr(smod, "load_sampling_fn", real)
    assert "note" not in smod.Sampler(cfg, ring_adjs(6, 8), device="cpu", log=False).sample(2)
