"""The S4 splitting solver and the SDE transition kernels it steps by, in
the port against the JAX package, on the CPU.

* ``VPSDE.transition`` and ``VESDE.transition`` at the solver's half steps
  (rtol = atol = 1e-5); ``subVPSDE`` has none and raises in both.
* The S4 solver, graph and CC mode, with VP and VE SDEs, over 1 and 5
  steps, shared weights and noise: each package's module-level noise
  functions and prior sampling are fed one numpy sequence in call order
  (per step: the Langevin correction's draw of each tensor, then the two
  half-step transitions' draws of each), as tests/test_torch_sampler.py
  and tests/test_torch_cc_sampler.py hold the PC samplers; rtol = atol =
  1e-4, their bound (the networks' f32 rounding fed back through the
  iteration).  The networks are those tests' (graph: N = 8, B = 4; CC:
  E = 28, K = 56, F's last layer × 0.01 in both packages: a seeded F grows
  with the cube of the rank-2 tensor and overflows within 5 S4 steps).
* ``sampler.predictor: S4`` configs build the solver the JAX package's
  ``load_sampling_fn`` builds (the S4 solver, graph or CC; the PC sampler
  otherwise); ``Sampler`` samples a tiny ScoreNetworkA_Base_CC config with
  it; the two-stage model's stage 2 refuses S4, as in JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ccsd_tpu.diffusion.solvers as jsolvers
from ccsd_tpu.diffusion import sde as jsde
from ccsd_tpu.diffusion.losses import get_score_fn as jget_score_fn
from ccsd_tpu.diffusion.losses import get_score_fn_cc as jget_score_fn_cc
from ccsd_tpu.models.registry import load_model as jload_model
from ccsd_tpu.sampling.sampler import load_sampling_fn as jload_sampling_fn
from ccsd_tpu.utils.config import get_config as jget_config

import ccsd_tpu_torch.diffusion.solvers as psolvers
from ccsd_tpu_torch.diffusion import sde as psde
from ccsd_tpu_torch.diffusion.losses import get_score_fn, get_score_fn_cc
from ccsd_tpu_torch.diffusion.two_stage import get_rank2_sampler
from ccsd_tpu_torch.models.registry import load_model
from ccsd_tpu_torch.sampling.sampler import Sampler, load_sampling_fn
from ccsd_tpu_torch.utils.config import get_config
from ccsd_tpu_torch.utils.from_jax import load_jax_params

from test_torch_base_cc import small_base_cc_configs
from test_torch_cc_models import E, JSPEC, K, SPEC, _networks, cc_inputs
from test_torch_cc_sampler import ring_adjs, tame_rank2_head  # noqa: F401 (fixture)
from test_torch_sampler import DEF_A, DEF_X

TOL = dict(rtol=1e-5, atol=1e-5)
B, N, F = 4, 8, 5


def _sde(kind, steps):
    if kind == "VP":
        return (jsde.VPSDE(N=steps, beta_min=0.1, beta_max=1.0),
                psde.VPSDE(N=steps, beta_min=0.1, beta_max=1.0))
    return (jsde.VESDE(N=steps, sigma_min=0.2, sigma_max=1.0),
            psde.VESDE(N=steps, sigma_min=0.2, sigma_max=1.0))


@pytest.mark.parametrize("kind", ["VP", "VE"])
def test_transition_matches_jax(kind):
    js, ps = _sde(kind, 1000)
    t = np.linspace(1.0, 1e-4, 53).astype(np.float32)
    dt = np.full_like(t, -1.0 / 2000)
    x = np.random.default_rng(0).standard_normal((53, 5, 5)).astype(np.float32)
    for tt in (t, t + dt):  # the first and the second half step
        want = js.transition(jnp.asarray(x), jnp.asarray(tt), jnp.asarray(dt))
        got = ps.transition(torch.from_numpy(x), torch.from_numpy(tt), torch.from_numpy(dt))
        for a, b in zip(got, want):
            np.testing.assert_allclose(np.broadcast_to(a.numpy(), np.shape(b)),
                                       np.asarray(b), **TOL)


def test_subvp_has_no_transition_in_either_package():
    x, t = np.zeros((2, 3), np.float32), np.full(2, 0.5, np.float32)
    with pytest.raises(NotImplementedError):
        jsde.subVPSDE(N=10).transition(jnp.asarray(x), jnp.asarray(t), jnp.asarray(t))
    with pytest.raises(NotImplementedError, match="subVPSDE"):
        psde.subVPSDE(N=10).transition(torch.from_numpy(x), torch.from_numpy(t),
                                       torch.from_numpy(t))


def _feed(seq, wrap):
    it = iter(seq)

    def raw(shape):
        z = next(it)
        assert z.shape == tuple(shape)
        return wrap(z)

    return raw


def _share_noise(monkeypatch, seq):
    """Feed both packages' noise and prior draws from ``seq``, in call
    order."""
    jraw, praw = _feed(seq, jnp.asarray), _feed(seq, torch.from_numpy)

    def jgen(key, x, fl, sym=True):
        z = jraw(x.shape)
        if sym:
            z = jnp.triu(z, 1)
            return jsolvers.mask_adjs(z + jnp.swapaxes(z, -1, -2), fl)
        return jsolvers.mask_x(z, fl)

    def pgen(x, fl, sym=True, generator=None):
        z = praw(x.shape)
        if sym:
            z = torch.triu(z, 1)
            return psolvers.mask_adjs(z + z.transpose(-1, -2), fl)
        return psolvers.mask_x(z, fl)

    monkeypatch.setattr(jsolvers, "gen_noise", jgen)
    monkeypatch.setattr(jsolvers, "gen_noise_rank2",
                        lambda key, x, spec, fl: jsolvers.mask_rank2(jraw(x.shape), spec, fl))
    monkeypatch.setattr(jsde.SDE, "prior_sampling",
                        lambda self, key, shape, dtype=None: jraw(shape))
    monkeypatch.setattr(jsde.SDE, "prior_sampling_sym",
                        lambda self, key, shape, dtype=None: (
                            lambda z: z + jnp.swapaxes(z, -1, -2))(jnp.triu(jraw(shape), 1)))
    monkeypatch.setattr(psolvers, "gen_noise", pgen)
    monkeypatch.setattr(psolvers, "gen_noise_rank2",
                        lambda x, spec, fl, generator=None: psolvers.mask_rank2(
                            praw(x.shape), spec, fl))
    monkeypatch.setattr(psde.SDE, "prior_sampling",
                        lambda self, shape, generator=None, device=None: praw(shape))
    monkeypatch.setattr(psde.SDE, "prior_sampling_sym",
                        lambda self, shape, generator=None, device=None: (
                            lambda z: z + z.transpose(-1, -2))(torch.triu(praw(shape), 1)))


def _graph_networks():
    out = []
    for i, d in enumerate((DEF_X, DEF_A)):
        jm = jload_model(d)
        p = jm.init(jax.random.PRNGKey(1 + i))
        out.append((jm, p, load_jax_params(load_model(d), p)))
    return out


@pytest.mark.parametrize("is_cc", [False, True], ids=["graph", "cc"])
@pytest.mark.parametrize("kinds", [("VP", "VP"), ("VP", "VE")], ids=["VP", "VP_VE"])
@pytest.mark.parametrize("steps", [1, 5])
def test_s4_solver_matches_jax(monkeypatch, is_cc, kinds, steps):
    """``kinds``: the SDE of x, then that of the adjacency and the rank-2
    tensor (the enzymes configs' VP x and VE adjacency and F)."""
    (jx, px), (ja, pa) = _sde(kinds[0], steps), _sde(kinds[1], steps)
    shapes = [(B, N, F), (B, N, N)] + [(B, E, K)] * is_cc
    per_step = shapes + [s for s in shapes for _ in range(2)]
    rng = np.random.default_rng(12 + steps)
    seq = [rng.standard_normal(s).astype(np.float32) for s in shapes + per_step * steps]
    _share_noise(monkeypatch, seq)
    kw = dict(snr=0.15, scale_eps=0.7, denoise=True, eps=1e-4)
    if is_cc:
        _, _, _, flags = cc_inputs(9)
        nets = [_networks(n, False, seed=i) for i, n in enumerate(("x", "adj", "rank2"))]
        jm, p, pm = nets[2]  # F's head x 0.01: a seeded F overflows within 5 steps
        p["final"]["linears"][-1]["w"] = p["final"]["linears"][-1]["w"] * 0.01
        nets[2] = (jm, p, load_jax_params(pm, p))
        jsolver = jsolvers.get_s4_solver(jx, ja, (B, N, F), (B, N, N), is_cc=True,
                                         sde_rank2=ja, shape_rank2=(B, E, K), spec=JSPEC, **kw)
        psolver = psolvers.get_s4_solver(px, pa, (B, N, F), (B, N, N), is_cc=True,
                                         sde_rank2=pa, shape_rank2=(B, E, K), spec=SPEC, **kw)
        jfns = [jget_score_fn_cc(s, m, p) for (m, p, _), s in zip(nets, (jx, ja, ja))]
        pfns = [get_score_fn_cc(s, m) for (_, _, m), s in zip(nets, (px, pa, pa))]
    else:
        flags = np.ones((B, N), np.float32)
        flags[0, 6:] = flags[2, 5:] = 0
        nets = _graph_networks()
        jsolver = jsolvers.get_s4_solver(jx, ja, (B, N, F), (B, N, N), **kw)
        psolver = psolvers.get_s4_solver(px, pa, (B, N, F), (B, N, N), **kw)
        jfns = [jget_score_fn(s, m, p) for (m, p, _), s in zip(nets, (jx, ja))]
        pfns = [get_score_fn(s, m) for (_, _, m), s in zip(nets, (px, pa))]
    with jax.disable_jit():
        jout = jsolver(*jfns, jnp.asarray(flags), jax.random.PRNGKey(0))
    pout = psolver(*pfns, torch.from_numpy(flags), None)
    assert pout.n_model_evals == steps  # each network once a step
    for name in ("x", "adj") + ("rank2",) * is_cc:
        got, want = getattr(pout, name).numpy(), np.asarray(getattr(jout, name))
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("name", ["enzymes_small", "enzymes_small_CC", "enzymes_small_Base_CC",
                                  "community_small_Base_CC", "grid_small_CC"])
def test_configs_build_the_solver_jax_builds(name):
    jcfg, cfg = jget_config(name, 0), get_config(name, 0)
    is_cc = bool(cfg.get("is_cc", False))
    if is_cc:  # the CC universe at a size that builds fast
        jcfg.data.max_node_num = cfg.data.max_node_num = 8
    want = jload_sampling_fn(jcfg, jcfg.sampler, jcfg.sample, is_cc, 4)
    got = load_sampling_fn(cfg, cfg.sampler, cfg.sample, 4, is_cc)
    assert got.__name__ == want.__name__
    assert got.__name__.startswith("solver") == (cfg.sampler.predictor == "S4")


def test_sampler_runs_s4_on_a_base_cc_config(tmp_path, tame_rank2_head):
    """``Sampler`` on a tiny ScoreNetworkA_Base_CC config with the enzymes
    configs' sampler (S4, VE adjacency and F): two graphs a round, finite."""
    cfg = small_base_cc_configs()[1]
    cfg.model.num_layers_mlp = 1
    cfg.sampler = get_config("enzymes_small_Base_CC", 0).sampler
    for k in ("adj", "rank2"):
        cfg.sde[k].type = "VE"
    for k in ("x", "adj", "rank2"):
        cfg.sde[k].num_scales = 3
    cfg.data.batch_size = 8
    cfg.sample.score_dtype = "f32"
    cfg.folder = str(tmp_path)
    adjs = ring_adjs(10, 8)
    res = Sampler(cfg, adjs[2:], adjs[:2], device="cpu", log=False).sample()
    assert cfg.sampler.predictor == "S4" and res["finite"]
    assert res["adj"].shape == (2, 8, 8) and res["rank2"].shape == (2, E, K)


def test_stage2_of_the_two_stage_model_refuses_s4():
    with pytest.raises(NotImplementedError, match="S4"):
        get_rank2_sampler(psde.VPSDE(N=3), SPEC, predictor="S4")
