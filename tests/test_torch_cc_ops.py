"""The port's rank-2 masks, Hodge operators, CC codec and community_small_CC
dataset against the JAX package's, on the CPU.

Small complexes: N = 8 nodes, cells of d = 3 nodes, so E = C(8, 2) = 28
edge rows and K = C(8, 3) = 56 cell columns, with ragged node flags (8, 6,
5 and 3 present nodes, one graph with a hole).  Inputs come from numpy.
Tolerances: the masks, the duals and the codec are exact (products by 0
and 1, gathers, scatters); the Hodge Laplacian and its powers rtol = atol
= 1e-5 (f32 sums of K = 56 products on each side, in another order).  The
dataset: community_small's 100 graphs at a seed, lifted and padded by each
package, equal exactly (the JAX package's own ``generate_dataset(...,
is_cc=True)`` and ``dataloader_cc``).
"""

import networkx as nx
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ccsd_tpu.data import cc_codec as jcodec
from ccsd_tpu.data import generators
from ccsd_tpu.data.loader import dataloader_cc as jdataloader_cc
from ccsd_tpu.ops import cells as jcells
from ccsd_tpu.ops import hodge as jhodge
from ccsd_tpu.ops import masks as jmasks
from ccsd_tpu.utils.config import get_config as jget_config

from ccsd_tpu_torch.data import cc_codec
from ccsd_tpu_torch.data.loader import (
    community_small_adjs,
    generated_adjs,
    init_features,
    lifted_rank2,
    split,
)
from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
from ccsd_tpu_torch.ops import cells, hodge, masks
from ccsd_tpu_torch.utils.config import get_config

N, D = 8, 3
TOL = dict(rtol=1e-5, atol=1e-5)
SPEC, JSPEC = cells.get_spec(N, D, D), jcells.get_spec(N, D, D)
E, K = SPEC.num_edges, SPEC.num_cells
LIFT = dict(lifting_procedure="path_based", lifting_procedure_kwargs="basic")


def flags_ragged(B=4):
    f = np.ones((B, N), np.float32)
    f[1, 6:] = 0
    f[2, 5:] = 0
    f[3, [1, 4, 5, 6, 7]] = 0  # a hole: nodes 0, 2, 3 present
    return f[:B]


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_spec_sizes_and_index_maps():
    assert (E, K) == (28, 56) == (JSPEC.num_edges, JSPEC.num_cells)
    np.testing.assert_array_equal(SPEC.edge_u, JSPEC.edge_u)
    np.testing.assert_array_equal(SPEC.edge_v, JSPEC.edge_v)
    np.testing.assert_array_equal(SPEC.cell_mask, JSPEC.cell_mask)


@pytest.mark.parametrize("fn", ["edge_flags", "cell_flags"])
def test_edge_and_cell_flags_match_jax(fn):
    f = flags_ragged()
    got = getattr(masks, fn)(SPEC, _t(f)).numpy()
    want = np.asarray(getattr(jmasks, fn)(JSPEC, jnp.asarray(f)))
    np.testing.assert_array_equal(got, want)
    assert got[0].all() and 0 < got[3].sum() < got.shape[1]


@pytest.mark.parametrize("channels", [None, 3])
def test_mask_rank2_matches_jax(channels):
    rng = np.random.default_rng(0)
    shape = (4, E, K) if channels is None else (4, channels, E, K)
    r = rng.standard_normal(shape).astype(np.float32)
    f = flags_ragged()
    got = masks.mask_rank2(_t(r), SPEC, _t(f)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasks.mask_rank2(jnp.asarray(r), JSPEC,
                                                                    jnp.asarray(f))))
    assert masks.mask_rank2(_t(r), SPEC, None) is not None


def test_gen_noise_rank2_is_masked_and_not_symmetrised():
    f = _t(flags_ragged())
    g = torch.Generator().manual_seed(0)
    z = masks.gen_noise_rank2(torch.zeros(4, E, K), SPEC, f, generator=g)
    z_raw = torch.randn((4, E, K), generator=torch.Generator().manual_seed(0))
    assert torch.equal(z, masks.mask_rank2(z_raw, SPEC, f))
    fl, fr = masks.rank2_flags(SPEC, f)
    assert (z[fl == 0] == 0).all() and (z.transpose(1, 2)[fr == 0] == 0).all()
    assert (z[fl[..., None].expand_as(z).bool() & fr[:, None].expand_as(z).bool()] != 0).all()


@pytest.mark.parametrize("channels", [None, 2])
def test_mask_hodge_adjs_matches_jax(channels):
    rng = np.random.default_rng(1)
    shape = (4, E, E) if channels is None else (4, channels, E, E)
    h = rng.standard_normal(shape).astype(np.float32)
    f = flags_ragged()
    got = masks.mask_hodge_adjs(_t(h), SPEC, _t(f)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasks.mask_hodge_adjs(
        jnp.asarray(h), JSPEC, jnp.asarray(f))))


def test_hodge_laplacian_matches_jax():
    r = np.random.default_rng(2).standard_normal((3, E, K)).astype(np.float32)
    np.testing.assert_allclose(hodge.hodge_laplacian(_t(r)).numpy(),
                               np.asarray(jhodge.hodge_laplacian(jnp.asarray(r))), **TOL)


@pytest.mark.parametrize("cnum,masked", [(1, True), (2, True), (3, True), (3, False)])
def test_pow_tensor_cc_matches_jax(cnum, masked):
    rng = np.random.default_rng(3)
    r = (rng.random((3, E, K)) < 0.1).astype(np.float32)  # incidence-like 0/1
    r[0] += rng.standard_normal((E, K)).astype(np.float32) * 0.1
    pm = hodge.hodgedual_mask_from_spec(SPEC) if masked else None
    jm = jhodge.hodgedual_mask_from_spec(JSPEC) if masked else None
    got = hodge.pow_tensor_cc(_t(r), cnum, pm).numpy()
    want = np.asarray(jhodge.pow_tensor_cc(jnp.asarray(r), cnum, jm))
    assert got.shape == (3, cnum, E, K)
    np.testing.assert_allclose(got, want, **TOL)


def test_hodgedual_round_trip_matches_jax():
    rng = np.random.default_rng(4)
    a = np.triu(rng.standard_normal((2, 3, N, N)).astype(np.float32), 1)
    a = a + np.swapaxes(a, -1, -2)
    hd = hodge.adj_to_hodgedual(_t(a))
    np.testing.assert_array_equal(hd.numpy(), np.asarray(jhodge.adj_to_hodgedual(
        jnp.asarray(a))))
    assert hd.shape == (2, 3, E, E)
    h = rng.standard_normal((2, 3, E, E)).astype(np.float32)
    np.testing.assert_array_equal(hodge.hodgedual_to_adj(_t(h)).numpy(),
                                  np.asarray(jhodge.hodgedual_to_adj(jnp.asarray(h))))
    np.testing.assert_array_equal(hodge.hodgedual_to_adj(hd).numpy(), a)
    np.testing.assert_array_equal(hodge.hodgedual_mask_from_spec(SPEC).numpy(),
                                  np.asarray(jhodge.hodgedual_mask_from_spec(JSPEC)))


# ----------------------------------------------------------------- codec ---

def _community_ccs(seed, num=12):
    """(JAX CCs, port CCs) of community_small's first ``num`` graphs at a
    seed, lifted by each package from its own graphs."""
    state = np.random.get_state()
    try:
        np.random.seed(seed)
        graphs = generators.gen_graph_list(
            "community", {"num_communities": [2], "max_nodes": np.arange(12, 21).tolist()},
            length=100)[:num]
    finally:
        np.random.set_state(state)
    jccs = jcodec.convert_graphs_to_CCs(graphs, **LIFT)
    ccs = cc_codec.convert_graphs_to_CCs(adjs_to_graphs(community_small_adjs(100, seed)[:num]),
                                         **LIFT)
    return jccs, ccs


def _cells(cc):
    return {r: dict(d) for r, d in cc.cells.hyperedge_dict.items()}


@pytest.mark.parametrize("seed", [0, 42])
def test_ccs_to_tensors_and_global_properties_match_jax(seed):
    jccs, ccs = _community_ccs(seed)
    assert cc_codec.get_global_cc_properties(ccs) == jcodec.get_global_cc_properties(jccs)
    for args in ((20, 3, 3), ()):
        got, want = cc_codec.ccs_to_tensors(ccs, *args), jcodec.ccs_to_tensors(jccs, *args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 42])
def test_cc_from_incidence_and_graphs_match_jax(seed):
    """Incidence tensors (the dataset's, and a noisy quantized one with
    nodes that only an edge brings in) back to CCs and 1-skeletons."""
    jccs, _ = _community_ccs(seed, num=6)
    adjs, rank2 = jcodec.ccs_to_tensors(jccs, 20, 3, 3)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(adjs), 20, 4)).astype(np.float32)
    x[:, 15:] = 0  # nodes 15.. only through their edges
    noisy = (rng.random(rank2.shape) < 0.002).astype(np.float32)
    for r2 in (rank2, np.maximum(rank2, noisy)):
        for i in range(len(adjs)):
            mats = [x[i], adjs[i], r2[i]]
            got = cc_codec.cc_from_incidence(mats, 3, 3)
            want = jcodec.cc_from_incidence(mats, 3, 3)
            assert _cells(got) == _cells(want)
            (g,), (h,) = cc_codec.convert_CC_to_graphs([got]), jcodec.convert_CC_to_graphs([want])
            np.testing.assert_array_equal(g.nodes, sorted(h.nodes))
            np.testing.assert_array_equal(g.adj, nx.to_numpy_array(h, nodelist=sorted(h.nodes)))


def test_convert_CC_to_graphs_keeps_isolated_nodes():
    cc = cc_codec.cc_from_incidence([np.eye(5, dtype=np.float32), np.zeros((5, 5), np.float32),
                                     np.zeros((10, 10), np.float32)], 3, 3)
    (g,) = cc_codec.convert_CC_to_graphs([cc])
    assert g.num_nodes == 5 and not g.adj.any()


@pytest.mark.parametrize("seed", [0, 42])
def test_community_small_CC_equals_the_jax_dataset(seed, tmp_path):
    """``lifted_rank2`` of the generated graphs against the JAX package's
    ``generate_dataset("community_small", is_cc=True)`` loaded by
    ``dataloader_cc``: features, adjacencies and incidences, both splits."""
    state = np.random.get_state()
    try:
        np.random.seed(seed)
        generators.generate_dataset("community_small", data_dir=str(tmp_path), is_cc=True)
    finally:
        np.random.set_state(state)
    jcfg = jget_config("community_small_CC", seed)
    jcfg.data.dir = str(tmp_path)
    jtrain, jtest = jdataloader_cc(jcfg, seed=seed)
    cfg = get_config("community_small_CC", seed)
    adjs = generated_adjs("community_small_CC", seed, 20)
    rank2 = lifted_rank2(adjs, cfg.data)
    assert rank2.shape == (100, 190, 1140)
    x = init_features("deg", adjs, 11)
    tr, te = split(100, 0.2)
    for want, sl in ((jtrain.arrays, tr), (jtest.arrays, te)):
        for w, g in zip(want, (x[sl], adjs[sl], rank2[sl])):
            np.testing.assert_array_equal(g, w)
