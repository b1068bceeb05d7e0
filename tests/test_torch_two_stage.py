"""The port's two-stage pieces against the JAX package's, on the CPU: the
dynamic rank-2 masks, the host bridge, the slab-unrolled ScoreNetworkF over
a per-sample universe, the stage-2 loss and the stage-2 sampler.

* Masks, noise masking, the bridge (candidate lists, member and valid, with
  and without ``k_max``, on community_small and grid_small graphs at three
  seeds, some with isolated nodes), ``incidence_from_dynamic``,
  ``dynamic_batch_from_ccs`` and ``ccs_from_two_stage``: exactly.
* ScoreNetworkF over a dynamic universe, and its fused form over the
  spec's: rtol = atol = 1e-5 (N = 8, E = 28, B = 4, one narrow layer).
* The stage-2 DSM loss on the JAX draws: rtol = 1e-5.
* The stage-2 sampler, 5 steps on one shared noise sequence (Euler and
  Reverse predictors, Langevin corrector; F's last layer × 0.01): rtol =
  atol = 1e-4, the networks' f32 rounding fed back through the
  iteration, as the CC sampler's test holds it; and a batch with no candidate cell at all gives
  zeros, not NaN, in both packages.
"""

import math

import networkx as nx
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ccsd_tpu.data import cc_codec as jcodec
from ccsd_tpu.diffusion import sde as jsde
from ccsd_tpu.diffusion import two_stage as jts
from ccsd_tpu.diffusion.losses import get_rank2_dynamic_loss_fn as jget_loss
from ccsd_tpu.diffusion.losses import get_score_fn_rank2_dynamic as jget_score
from ccsd_tpu.ops import cells as jcells
from ccsd_tpu.ops import masks as jmasks

from ccsd_tpu_torch.data import cc_codec
from ccsd_tpu_torch.data.loader import community_small_adjs, grid_adjs
from ccsd_tpu_torch.diffusion import sde as psde
from ccsd_tpu_torch.diffusion import two_stage as pts
from ccsd_tpu_torch.diffusion.losses import Rank2DynamicLoss, get_score_fn_rank2_dynamic
from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
from ccsd_tpu_torch.ops import masks as pmasks
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.utils.from_jax import load_jax_params

from test_torch_cc_models import B, JSPEC, N, SPEC, _networks, _t, cc_inputs

E = SPEC.num_edges
LIFT = dict(lifting_procedure="path_based", path_length=3)
TOL = dict(rtol=1e-5, atol=1e-5)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _graphs(family, seed, drop_nodes=False):
    """20 padded adjacencies of the family; with ``drop_nodes``, a few
    nodes cut off, as a generated graph may leave them."""
    if family == "community_small":
        a = community_small_adjs(20, seed)
    else:
        a = grid_adjs(20, seed, 49, range(4, 8), range(4, 8))
    if drop_nodes:
        rng = np.random.default_rng(seed)
        for g in a:
            cut = rng.integers(0, a.shape[1], 3)
            g[cut] = 0
            g[:, cut] = 0
    return a


def _jdyn(dyn):
    """The JAX package's DynamicCells of the port's."""
    return jts.DynamicCells(jnp.asarray(dyn.member.numpy()), jnp.asarray(dyn.valid.numpy()),
                            dyn.cell_lists)


def _dyn_inputs(seed):
    """cc_inputs' graphs, their flags, the bridge's universe (capped at 12
    slots) and a noisy rank-2 state over it."""
    _, adj, _, flags = cc_inputs(seed)
    dyn = pts.dynamic_cells_from_adjs(adj, 3, 3, 12, **LIFT)
    rng = np.random.default_rng(seed)
    r2 = rng.standard_normal((B, E, dyn.k_max)).astype(np.float32)
    return adj, flags, dyn, r2


# ------------------------------------------------------------------ masks --

@pytest.mark.parametrize("channels", [False, True])
def test_dynamic_masks_match_jax_exactly(channels):
    adj, flags, dyn, r2 = _dyn_inputs(0)
    flags[1, 2] = 0  # a member node gone: its cells die
    if channels:
        r2 = np.stack([r2, 2 * r2], 1)
    m, v = dyn.member.numpy(), dyn.valid.numpy()
    _eq(pmasks.cell_flags_dynamic(dyn.member, dyn.valid, _t(flags)),
        jmasks.cell_flags_dynamic(jnp.asarray(m), jnp.asarray(v), jnp.asarray(flags)))
    for fl in (flags, None):
        want = jmasks.mask_rank2_dynamic(jnp.asarray(r2), JSPEC, jnp.asarray(m), jnp.asarray(v),
                                         None if fl is None else jnp.asarray(fl))
        _eq(pmasks.mask_rank2_dynamic(_t(r2), SPEC, dyn.member, dyn.valid,
                                      None if fl is None else _t(fl)), want)


def test_dynamic_noise_is_gaussian_masked_by_the_dynamic_mask():
    adj, flags, dyn, r2 = _dyn_inputs(1)
    x = _t(r2)
    z = pmasks.gen_noise_rank2_dynamic(x, SPEC, dyn.member, dyn.valid, _t(flags),
                                       torch.Generator().manual_seed(5))
    raw = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    want = jmasks.mask_rank2_dynamic(jnp.asarray(raw.numpy()), JSPEC,
                                     jnp.asarray(dyn.member.numpy()),
                                     jnp.asarray(dyn.valid.numpy()), jnp.asarray(flags))
    _eq(z, want)


# ----------------------------------------------------------------- bridge --

@pytest.mark.parametrize("family", ["community_small", "grid_small"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_max", [None, 30])
def test_bridge_matches_jax_exactly(family, seed, k_max):
    adjs = _graphs(family, seed, drop_nodes=seed == 2)
    got = pts.dynamic_cells_from_adjs(adjs, 3, 3, k_max, **LIFT)
    want = jts.dynamic_cells_from_adjs(adjs, 3, 3, k_max, **LIFT)
    assert got.cell_lists == want.cell_lists
    _eq(got.member, want.member)
    _eq(got.valid, want.valid)
    if k_max is not None:
        full = pts.dynamic_cells_from_adjs(adjs, 3, 3, None, **LIFT)
        assert got.k_max == min(k_max, full.k_max) and full.k_max > k_max
        assert all(c == f[:k_max] for c, f in zip(got.cell_lists, full.cell_lists))


def test_bridge_of_graphs_with_no_candidate():
    adjs = np.zeros((3, 8, 8), np.float32)
    adjs[1, 0, 1] = adjs[1, 1, 0] = 1  # one edge: no path of 3 nodes
    got = pts.dynamic_cells_from_adjs(adjs, 3, 3, None, **LIFT)
    want = jts.dynamic_cells_from_adjs(adjs, 3, 3, None, **LIFT)
    assert got.k_max == 1 and got.cell_lists == want.cell_lists == ((), (), ())
    _eq(got.member, want.member)
    _eq(got.valid, want.valid)


def test_cycles_lift_raises_naming_the_cycle_basis():
    with pytest.raises(NotImplementedError, match="cycle basis"):
        pts.dynamic_cells_from_adjs(_graphs("community_small", 0), 3, 3, None, "cycles")


def _jax_ccs(adjs):
    n = [int((a.sum(-1) > 0).sum()) for a in adjs]
    return jcodec.convert_graphs_to_CCs(
        [nx.from_numpy_array(a[:k, :k]) for a, k in zip(adjs, n)],
        lifting_procedure="path_based", lifting_procedure_kwargs="basic", max_nb_nodes=max(n))


@pytest.mark.parametrize("k_max", [None, 40])
def test_dynamic_batch_and_incidence_match_jax_exactly(k_max):
    adjs = community_small_adjs(12, 3)
    spec, jspec = get_spec(20, 3, 3), jcells.get_spec(20, 3, 3)
    jccs = _jax_ccs(adjs)
    ccs = cc_codec.convert_graphs_to_CCs(adjs_to_graphs(adjs), lifting_procedure="path_based",
                                         lifting_procedure_kwargs="basic")
    # drop some actual cells so the target has absent candidates
    for cc, jcc in zip(ccs, jccs):
        for c in sorted(cc.cells.hyperedge_dict[2], key=sorted)[::3]:
            del cc.cells.hyperedge_dict[2][c]
            del jcc.cells.hyperedge_dict[2][c]
    adj, rank2, dyn = pts.dynamic_batch_from_ccs(ccs, spec, 3, 3, k_max, **LIFT)
    jadj, jrank2, jdyn = jts.dynamic_batch_from_ccs(jccs, jspec, 3, 3, k_max, **LIFT)
    assert dyn.cell_lists == jdyn.cell_lists
    for g, w in ((adj, jadj), (rank2, jrank2), (dyn.member, jdyn.member),
                 (dyn.valid, jdyn.valid)):
        _eq(g, w)
    assert 0 < rank2.sum() < pts.incidence_from_dynamic(adj, spec, dyn).sum()
    # the incidence of a noisy adjacency over that universe
    noisy = adj.clone()
    noisy[:, 0, 5] = noisy[:, 5, 0] = 1 - noisy[:, 0, 5]
    _eq(pts.incidence_from_dynamic(noisy, spec, dyn),
        jts.incidence_from_dynamic(jnp.asarray(noisy.numpy()), jspec, jdyn))


def _hyperedges(cc):
    return {r: dict(d) for r, d in cc.cells.hyperedge_dict.items()}


def test_decoding_matches_jax():
    adjs = _graphs("community_small", 4, drop_nodes=True)[:8]
    spec, jspec = get_spec(20, 3, 3), jcells.get_spec(20, 3, 3)
    dyn = pts.dynamic_cells_from_adjs(adjs, 3, 3, 50, **LIFT)
    rng = np.random.default_rng(4)
    rank2_q = ((rng.random((8, spec.num_edges, dyn.k_max)) < 0.02)
               * dyn.valid.numpy()[:, None, :]).astype(np.uint8)
    x = rng.standard_normal((8, 20, 5)).astype(np.float32)
    jdyn = _jdyn(dyn)
    got = pts.ccs_from_two_stage(x, adjs, rank2_q, dyn, spec)
    want = jts.ccs_from_two_stage(x, adjs, rank2_q, jdyn, jspec)
    assert [_hyperedges(c) for c in got] == [_hyperedges(c) for c in want]
    assert sum(len(c.cells.hyperedge_dict.get(2, {})) for c in got) > 0
    with pytest.raises(NotImplementedError, match="molecule"):
        pts.ccs_from_two_stage(x, adjs, rank2_q, dyn, spec, is_molecule=True)


# ------------------------------------------------------- network and loss --

@pytest.mark.parametrize("dynamic", [True, False])
def test_score_f_slab_form_matches_jax(dynamic):
    """ScoreNetworkF (cnum 2, one HodgeNetworkLayer, the final layer one
    Linear) over the bridge's universe, or fused over the spec's."""
    jm, p, pm = _networks("rank2", fused=not dynamic)
    adj, flags, dyn, r2 = _dyn_inputs(2)
    if dynamic:
        jdyn = (jnp.asarray(dyn.member.numpy()), jnp.asarray(dyn.valid.numpy()))
        want = jm.apply(p, None, None, jnp.asarray(r2), flags=jnp.asarray(flags), dyn=jdyn)
        got = pm(None, None, _t(r2), flags=_t(flags), dyn=(dyn.member, dyn.valid))
    else:
        _, _, r2, _ = cc_inputs(2)
        want = jm.apply(p, None, None, jnp.asarray(r2), flags=jnp.asarray(flags))
        got = pm(None, None, _t(r2), flags=_t(flags))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["VP", "VE"])
def test_dynamic_loss_matches_jax_on_the_jax_draws(kind):
    jm, p, pm = _networks("rank2", False, seed=3)
    adj, flags, dyn, _ = _dyn_inputs(3)
    target = pts.incidence_from_dynamic(_t(adj), SPEC, dyn).numpy()
    if kind == "VP":
        js, ps = jsde.VPSDE(1000, 0.1, 1.0), psde.VPSDE(1000, 0.1, 1.0)
    else:
        js, ps = jsde.VESDE(1000, 0.1, 1.0), psde.VESDE(1000, 0.1, 1.0)
    jdyn = _jdyn(dyn)
    m, v, fl = jdyn.member, jdyn.valid, jnp.asarray(flags)
    key = jax.random.PRNGKey(11)
    want = jget_loss(js, jm, JSPEC, eps=1e-5)(p, jnp.asarray(target), fl, m, v, key)
    k_t, k_z = jax.random.split(key)  # the JAX draws (losses.py:287-293)
    t = jax.random.uniform(k_t, (B,)) * (js.T - 1e-5) + 1e-5
    z = jmasks.gen_noise_rank2_dynamic(k_z, jnp.asarray(target), JSPEC, m, v, fl)
    got = Rank2DynamicLoss(ps, SPEC, eps=1e-5).losses(
        pm, _t(target), _t(flags), dyn.member, dyn.valid, _t(t), _t(z))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # the draws: t, then the masked noise, from the one generator
    t2, z2 = Rank2DynamicLoss(ps, SPEC).draw(_t(target), _t(flags), dyn.member, dyn.valid,
                                             torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    torch.rand((B,), generator=g)
    assert torch.equal(z2, pmasks.mask_rank2_dynamic(torch.randn(z2.shape, generator=g), SPEC,
                                                     dyn.member, dyn.valid, _t(flags)))
    assert t2.shape == (B,) and bool(((t2 >= 1e-5) & (t2 < 1)).all())


# ---------------------------------------------------------- stage-2 sampler --

def _shared_noise(monkeypatch, seq):
    """Feed both packages' stage-2 noise and prior from one sequence."""
    its = {"jax": iter(seq), "port": iter(seq)}

    def nxt(side, shape):
        z = next(its[side])
        assert z.shape == tuple(shape)
        return z

    monkeypatch.setattr(jts, "gen_noise_rank2_dynamic",
                        lambda key, x, spec, m, v, fl: jmasks.mask_rank2_dynamic(
                            jnp.asarray(nxt("jax", x.shape)), spec, m, v, fl))
    monkeypatch.setattr(jsde.VPSDE, "prior_sampling",
                        lambda self, key, shape, dtype=None: jnp.asarray(nxt("jax", shape)))
    monkeypatch.setattr(pts, "gen_noise_rank2_dynamic",
                        lambda x, spec, m, v, fl, generator=None: pmasks.mask_rank2_dynamic(
                            torch.from_numpy(nxt("port", x.shape)), spec, m, v, fl))
    monkeypatch.setattr(psde.VPSDE, "prior_sampling",
                        lambda self, shape, generator=None, device=None: torch.from_numpy(
                            nxt("port", shape)))


def _run_both(monkeypatch, predictor, adj, flags, steps=5, head_scale=0.01, stats=None):
    # F's last layer × 0.01: the seeded network's H²F channel is cubic in
    # F and overflows a few-step sampler (as in test_torch_cc_sampler.py)
    jm, p, pm = _networks("rank2", False, seed=6)
    last = p["final"]["linears"][-1]
    last["w"] = last["w"] * head_scale
    load_jax_params(pm, p)
    dyn = pts.dynamic_cells_from_adjs(adj, 3, 3, 12, **LIFT)
    shape = (B, E, dyn.k_max)
    rng = np.random.default_rng(7)
    _shared_noise(monkeypatch, [rng.standard_normal(shape).astype(np.float32)
                                for _ in range(1 + 2 * steps)])
    kw = dict(predictor=predictor, corrector="Langevin", snr=0.05, scale_eps=0.7, n_steps=1,
              probability_flow=False, denoise=True, eps=1e-4)
    js, ps = jsde.VPSDE(steps, 0.1, 1.0), psde.VPSDE(steps, 0.1, 1.0)
    jdyn = _jdyn(dyn)
    with jax.disable_jit():
        want = jts.get_rank2_sampler(js, JSPEC, **kw)(
            jget_score(js, jm, p, jdyn), jdyn, jnp.asarray(flags), jax.random.PRNGKey(0), shape)
    got = pts.get_rank2_sampler(ps, SPEC, **kw)(
        get_score_fn_rank2_dynamic(ps, pm, dyn), dyn, _t(flags), None, shape, stats)
    return got.numpy(), np.asarray(want), dyn


@pytest.mark.parametrize("predictor", ["Euler", "Reverse"])
def test_stage2_sampler_matches_jax_on_shared_noise(monkeypatch, predictor):
    _, adj, _, flags = cc_inputs(8)
    got, want, dyn = _run_both(monkeypatch, predictor, adj, flags)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(want).max() > 0.1
    dead = pmasks.mask_rank2_dynamic(torch.ones(got.shape), SPEC, dyn.member, dyn.valid,
                                     _t(flags)).numpy() == 0
    assert not got[dead].any()


def test_stage2_sampler_on_a_batch_without_candidates_gives_zeros(monkeypatch):
    """No graph has a path of 3 nodes: every slot is padding, the score
    and the noise are 0, and the floored Langevin step is 0, not 0/0."""
    adj = np.zeros((B, N, N), np.float32)
    adj[:, 0, 1] = adj[:, 1, 0] = 1
    flags = (adj.sum(-1) > 0).astype(np.float32)
    got, want, dyn = _run_both(monkeypatch, "Euler", adj, flags)
    assert dyn.k_max == 1 and not dyn.valid.any()
    assert np.isfinite(want).all() and not want.any()
    _eq(got, want)


@pytest.mark.parametrize("head_scale", [0.01, 1.0])
def test_stage2_sampler_reports_its_margin_to_overflow(monkeypatch, head_scale):
    """``stats``: the steps after which F was still finite and its largest
    |F| over them.  The tamed network stays finite all 5 steps; the seeded
    one overflows within them, in both packages, and the largest |F|
    counts only the finite steps."""
    _, adj, _, flags = cc_inputs(8)
    stats = {}
    with np.errstate(all="ignore"):
        got, want, _ = _run_both(monkeypatch, "Euler", adj, flags, head_scale=head_scale,
                                 stats=stats)
    assert set(stats) == {"finite_steps", "max_abs"} and math.isfinite(stats["max_abs"])
    if head_scale < 1:
        assert stats["finite_steps"] == 5 and np.isfinite(want).all()
        assert stats["max_abs"] >= np.abs(got).max() > 0.1
    else:
        assert stats["finite_steps"] < 5
        assert not np.isfinite(got).all() and not np.isfinite(want).all()
