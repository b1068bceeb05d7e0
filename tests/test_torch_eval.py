"""The port's MMD evaluation (graph and lifted-CC) against the JAX package's.

The port evaluates cleaned adjacency arrays without networkx
(``ccsd_tpu_torch.eval``); the JAX package evaluates networkx graphs.  On the
same adjacency sets, every worker's histogram must be equal exactly, and
every MMD equal after the 6-decimal rounding and within 1e-12 raw.  The sets:
community_small's test split (padded arrays for the port, the
``gen_graph_list`` graphs themselves for JAX, seeds 0 and 42) and quantized
random arrays with isolated nodes, self-loops, an all-zero graph, bipartite
components (eigenvalue 2, the top edge of the spectral histogram) and
triangle-rich blocks.  Also the orbit library, the CC lift, the sampler's
protocol and the CLI.
"""

import json
import math

import networkx as nx
import numpy as np
import pytest

from ccsd_tpu.data import generators
from ccsd_tpu.data.cc_codec import CC_to_incidence_matrices as jCC_to_incidence
from ccsd_tpu.data.cc_codec import convert_graphs_to_CCs as jconvert
from ccsd_tpu.data.cc_codec import pad_rank2 as jpad_rank2
from ccsd_tpu.data.complex import CombinatorialComplex as JCC
from ccsd_tpu.data.loader import init_flags as jinit_flags
from ccsd_tpu.eval import cc_stats as jcc_stats
from ccsd_tpu.eval import mmd as jmmd
from ccsd_tpu.eval import stats as jstats
from ccsd_tpu.eval.orbits import orbit_counts as jorbit_counts
from ccsd_tpu.eval.orbits import orbit_counts_py as jorbit_counts_py
from ccsd_tpu.ops import cells as jcells
from ccsd_tpu.sampling.sampler import Sampler as JSampler
from ccsd_tpu.utils.config import AttrDict as JAttrDict

from ccsd_tpu_torch.data.cc_codec import CC_to_incidence_matrices, convert_graphs_to_CCs, pad_rank2
from ccsd_tpu_torch.data.complex import CombinatorialComplex
from ccsd_tpu_torch.data.loader import community_small_adjs
from ccsd_tpu_torch.eval import cc_stats, mmd, orbits, stats
from ccsd_tpu_torch.eval.graphs import Graph, adj_to_graph, adjs_to_graphs, edge_list
from ccsd_tpu_torch.ops import cells
from ccsd_tpu_torch.sampling import sampler as psampler
from ccsd_tpu_torch.utils.config import AttrDict

N = 20
LIFT = dict(lifting_procedure="path_based", lifting_procedure_kwargs="basic", max_nb_nodes=N)
WORKER_KWARGS = dict(min_node_val=1, max_node_val=1, node_label="weight", min_edge_val=1,
                     max_edge_val=1, edge_label="weight", d_min=3, d_max=3, N=N)


def community_test_split(seed):
    """(the JAX package's test graphs, the port's padded test arrays) of
    community_small at a seed: the first 20 of 100."""
    state = np.random.get_state()
    try:
        np.random.seed(seed)
        graphs = generators.gen_graph_list(
            "community", {"num_communities": [2], "max_nodes": np.arange(12, 21).tolist()},
            length=100)
    finally:
        np.random.set_state(state)
    return graphs[:20], community_small_adjs(100, seed)[:20]


def block(a, nodes, sub):
    a[np.ix_(nodes, nodes)] = sub


def random_adjs(seed, count=12):
    """Quantized (count, N, N) arrays: random sparse graphs (isolated nodes
    among them), plus self-loops, an all-zero graph, a graph with only a
    self-loop, bipartite components and triangle-rich blocks."""
    rng = np.random.default_rng(seed)
    a = (rng.random((count, N, N)) < rng.uniform(0.05, 0.3, (count, 1, 1))).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.transpose(0, 2, 1)
    a[0, [2, 5], [2, 5]] = 1  # self-loops
    a[1] = 0  # empty: one node labelled 1
    a[2] = 0
    a[2, 7, 7] = 1  # only a self-loop: empty too
    a[3] = 0  # two bipartite components, K(3,4) and a path
    kb = np.zeros((7, 7), np.float32)
    kb[:3, 3:] = kb[3:, :3] = 1
    block(a[3], np.arange(2, 9), kb)
    a[3, [12, 13, 14], [13, 14, 15]] = a[3, [13, 14, 15], [12, 13, 14]] = 1
    a[4] = 0  # a K6 and a triangle
    block(a[4], np.arange(6), 1 - np.eye(6, dtype=np.float32))
    block(a[4], np.array([10, 11, 12]), 1 - np.eye(3, dtype=np.float32))
    a[5, :8, :8] = 1 - np.eye(8, dtype=np.float32)  # a dense block in a random graph
    a[6] = 0  # a single edge and an isolated rest
    a[6, 4, 9] = a[6, 9, 4] = 1
    a[7] = 0  # a 4-cycle (bipartite) and a star
    a[7, [0, 1, 2, 3], [1, 2, 3, 0]] = a[7, [1, 2, 3, 0], [0, 1, 2, 3]] = 1
    a[7, 10, 11:16] = a[7, 11:16, 10] = 1
    return a


def jax_graphs(adjs):
    return jstats.adjs_to_graphs(adjs)


SETS = {
    "community0": lambda: community_test_split(0),
    "community42": lambda: community_test_split(42),
    "random1": lambda: (jax_graphs(a := random_adjs(1)), a),
    "random2": lambda: (jax_graphs(a := random_adjs(2, 20)), a),
}


@pytest.fixture(scope="module")
def sets():
    return {k: f() for k, f in SETS.items()}


def port_graphs(sets, name):
    return adjs_to_graphs(sets[name][1])


# ------------------------------------------------------------ graphs --


@pytest.mark.parametrize("name", list(SETS))
def test_cleaned_graphs_equal_networkx(sets, name):
    """Node labels and adjacency as networkx leaves them; community_small's
    test graphs come out of the padded arrays as the raw generated graphs
    (no node of a community graph is isolated)."""
    jg, adjs = sets[name]
    for G, g in zip(jg, adjs_to_graphs(adjs), strict=True):
        nodes = list(G.nodes())
        assert g.nodes.tolist() == nodes
        if G.number_of_edges():
            np.testing.assert_array_equal(g.adj, nx.to_numpy_array(G, nodelist=nodes))
        else:
            assert nodes == [1] and g.adj.tolist() == [[0]]


def test_adj_to_graph_rejects_weights_and_shapes():
    with pytest.raises(ValueError, match="0 or 1"):
        adj_to_graph(np.full((3, 3), 0.5))
    with pytest.raises(ValueError, match="square"):
        adj_to_graph(np.zeros((3, 4)))


def test_asymmetric_entry_makes_an_edge():
    a = np.zeros((4, 4))
    a[0, 2] = 1
    G = nx.from_numpy_array(a)
    g = adj_to_graph(a)
    assert g.nodes.tolist() == [0, 2] and g.adj.tolist() == [[0, 1], [1, 0]]
    assert sorted(G.edges()) == [(0, 2)]


# ----------------------------------------------------------- workers --

WORKERS = {
    "degree": (stats.degree_worker, jstats.degree_worker),
    "cluster": (stats.clustering_worker, jstats.clustering_worker),
    "spectral": (stats.spectral_worker, jstats.spectral_worker),
    "orbit": (stats.orbit_worker,
              lambda G: jorbit_counts(G).sum(axis=0) / G.number_of_nodes()),
}


@pytest.mark.parametrize("name", list(SETS))
@pytest.mark.parametrize("worker", list(WORKERS))
def test_worker_equals_networkx_exactly(sets, name, worker):
    port, jax_ = WORKERS[worker]
    jg, adjs = sets[name]
    for G, g in zip(jg, adjs_to_graphs(adjs), strict=True):
        got, want = port(g), jax_(G)
        assert got.dtype.kind == np.asarray(want).dtype.kind
        np.testing.assert_array_equal(got, want)


def test_spectral_histogram_counts_eigenvalue_two():
    """Bipartite components have eigenvalue 2, the histogram's top edge: a
    last-ulp difference in the Laplacian would drop it from the count."""
    g = adjs_to_graphs(random_adjs(1))[3]
    eigs = np.linalg.eigvalsh(stats.normalized_laplacian(g))
    assert np.isclose(eigs.max(), 2.0)
    assert stats.spectral_worker(g).sum() == pytest.approx(1.0)
    assert stats.spectral_worker(g)[-1] > 0


def test_clustering_values_on_bin_edges():
    """0.5, 1/3 and 1.0 sit on or next to bin edges: each lands in the bin
    networkx's value lands in."""
    G = nx.Graph([(0, 1), (1, 2), (2, 0), (2, 3), (3, 0), (0, 4), (4, 5), (5, 0)])
    g = adj_to_graph(nx.to_numpy_array(G))
    want = nx.clustering(G)
    np.testing.assert_array_equal(stats.clustering_coefficients(g),
                                  [want[v] for v in G.nodes()])
    np.testing.assert_array_equal(stats.clustering_worker(g), jstats.clustering_worker(G))


PAIRS = [("community0", "random1"), ("community42", "random2"), ("community0", "community42"),
         ("random2", "random1")]


@pytest.mark.parametrize("ref,pred", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("method", ["degree", "cluster", "orbit", "spectral"])
def test_mmd_equals_jax(sets, ref, pred, method):
    kernel = stats.load_eval_settings()[1][method]
    jkernel = jstats.load_eval_settings()[1][method]
    got = stats.METHOD_NAME_TO_FUNC[method](port_graphs(sets, ref), port_graphs(sets, pred),
                                            kernel)
    want = jstats.METHOD_NAME_TO_FUNC[method](sets[ref][0], sets[pred][0], jkernel)
    assert math.isfinite(got) and abs(got - want) <= 1e-12


@pytest.mark.parametrize("ref,pred", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_eval_graph_list_equals_jax(sets, ref, pred):
    methods, kernels = stats.load_eval_settings()
    jmethods, jkernels = jstats.load_eval_settings()
    assert methods == jmethods
    got = stats.eval_graph_list(port_graphs(sets, ref), port_graphs(sets, pred), methods, kernels)
    want = jstats.eval_graph_list(sets[ref][0], sets[pred][0], jmethods, jkernels)
    assert got == want


@pytest.mark.parametrize("name", list(SETS))
def test_mmd_of_a_set_with_itself_is_zero(sets, name):
    g = port_graphs(sets, name)
    assert set(stats.eval_graph_list(g, g, *stats.load_eval_settings()).values()) == {0.0}
    ccs = convert_graphs_to_CCs(g, **LIFT)
    assert set(cc_stats.eval_CC_list(ccs, ccs, WORKER_KWARGS).values()) == {0.0}


@pytest.mark.parametrize("kernel", ["gaussian_emd", "gaussian", "gaussian_tv"])
@pytest.mark.parametrize("is_hist", [True, False])
def test_compute_mmd_equals_jax(kernel, is_hist):
    rng = np.random.default_rng(7)
    s1 = [rng.integers(0, 5, rng.integers(1, 12)).astype(float) for _ in range(9)]
    s2 = [rng.integers(0, 5, rng.integers(1, 12)).astype(float) for _ in range(6)]
    s2[0][:] = 0  # an all-zero histogram is left as it is
    kw = dict(sigma=0.7, distance_scaling=3.0) if kernel == "gaussian_emd" else dict(sigma=0.7)
    got = mmd.compute_mmd(s1, s2, getattr(mmd, kernel), is_hist=is_hist, **kw)
    want = jmmd.compute_mmd(s1, s2, getattr(jmmd, kernel), is_hist=is_hist, **kw)
    assert got == want
    for a, b in zip(s1, s2):
        assert getattr(mmd, kernel)(a, b, sigma=0.7) == getattr(jmmd, kernel)(a, b, sigma=0.7)
    assert mmd.emd(s1[0], s2[1], 2.0) == jmmd.emd(s1[0], s2[1], 2.0)


# ------------------------------------------------------------ orbits --

FIXTURES = {
    "triangle": nx.complete_graph(3),
    "path4": nx.path_graph(4),
    "star": nx.star_graph(3),
    "cycle4": nx.cycle_graph(4),
    "k4": nx.complete_graph(4),
    "paw": nx.Graph([(0, 1), (1, 2), (2, 0), (2, 3)]),
    "diamond": nx.Graph([(0, 1), (0, 2), (1, 2), (1, 3), (2, 3)]),
    **{f"gnp12_{s}": nx.gnp_random_graph(12, 0.35, seed=s) for s in range(3)},
    **{f"random{s}": nx.gnp_random_graph(int(8 + s % 9), 0.2 + 0.03 * (s % 10), seed=100 + s)
       for s in range(20)},
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_orbit_library_equals_jax_and_brute_force(name):
    G = FIXTURES[name]
    nodes = sorted(G.nodes())
    assert list(G.nodes()) == nodes
    g = Graph(nx.to_numpy_array(G, nodelist=nodes).astype(np.int64), np.array(nodes))
    got = orbits.orbit_counts(g)
    np.testing.assert_array_equal(got, jorbit_counts(G))
    edges = [tuple(e) for e in edge_list(g).tolist()]
    np.testing.assert_array_equal(got, orbits.orbit_counts_py(len(nodes), edges))
    np.testing.assert_array_equal(orbits.orbit_counts_py(len(nodes), edges),
                                  jorbit_counts_py(len(nodes), edges))


def test_orbit_sources_are_the_jax_packages_and_build_under_build():
    import os

    import ccsd_tpu.eval.orbits as jorbits

    for path in orbits.SOURCES:
        with open(path, "rb") as f, open(
                os.path.join(os.path.dirname(jorbits.__file__), os.path.basename(path)),
                "rb") as g:
            assert f.read() == g.read()
    assert orbits.library()._name == orbits.library_path()
    assert os.path.relpath(orbits.library_path(), orbits.BUILD_DIR).startswith("libgraphlet")


def test_orbit_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "graphlet_orbits.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(orbits, "SOURCES", [str(bad)])
    monkeypatch.setattr(orbits, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(orbits, "library_path",
                        lambda: str(tmp_path / "build" / "libgraphlet_orbits-bad.so"))
    orbits.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed .*\n.*error"):
            orbits.library()
    finally:
        orbits.library.cache_clear()


# -------------------------------------------------------- lifted CCs --


def cell_sets(cc):
    return {r: set(d) for r, d in cc.cells.hyperedge_dict.items()}


@pytest.mark.parametrize("name", list(SETS))
def test_lifted_ccs_equal_jax(sets, name):
    jg, adjs = sets[name]
    got = convert_graphs_to_CCs(adjs_to_graphs(adjs), **LIFT)
    want = jconvert(jg, **LIFT)
    for p, j in zip(got, want, strict=True):
        assert cell_sets(p) == cell_sets(j)
        fp = CC_to_incidence_matrices(p, 3, 3)[2]
        fj = jCC_to_incidence(j, 3, 3)[2]
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_array_equal(pad_rank2(fp, N, 3, 3), jpad_rank2(fj, N, 3, 3))


@pytest.mark.parametrize("ref,pred", PAIRS, ids=["-".join(p) for p in PAIRS])
def test_eval_CC_list_equals_jax(sets, ref, pred):
    ccs = {k: convert_graphs_to_CCs(port_graphs(sets, k), **LIFT) for k in (ref, pred)}
    jccs = {k: jconvert(sets[k][0], **LIFT) for k in (ref, pred)}
    got = cc_stats.eval_CC_list(ccs[ref], ccs[pred], WORKER_KWARGS)
    want = jcc_stats.eval_CC_list(jccs[ref], jccs[pred], WORKER_KWARGS)
    assert got == want
    for m in cc_stats.load_cc_eval_settings()[0]:
        a = cc_stats.CC_METHOD_NAME_TO_FUNC[m](ccs[ref], ccs[pred], WORKER_KWARGS)
        b = jcc_stats.CC_METHOD_NAME_TO_FUNC[m](jccs[ref], jccs[pred], WORKER_KWARGS)
        assert math.isfinite(a) and abs(a - b) <= 1e-12


def test_empty_graph_lifts_to_one_node_with_a_zero_spectrum():
    g = adjs_to_graphs(np.zeros((1, N, N)))[0]
    assert g.nodes.tolist() == [1]
    (cc,) = convert_graphs_to_CCs([g], **LIFT)
    assert cell_sets(cc) == {0: {frozenset({0})}}
    (jcc,) = jconvert(jstats.adjs_to_graphs(np.zeros((1, N, N))), **LIFT)
    assert cell_sets(jcc) == cell_sets(cc)
    spec = cc_stats.hodge_laplacian_spectrum_worker(cc, 3, 3, N)
    np.testing.assert_array_equal(spec, np.zeros(N * (N - 1) // 2, np.float32))


def test_cycles_lift_raises():
    with pytest.raises(NotImplementedError, match="cycles lift"):
        convert_graphs_to_CCs(adjs_to_graphs(random_adjs(1)), lifting_procedure="cycles")


def test_complex_container_equals_jax():
    for cls in (CombinatorialComplex, JCC):
        with pytest.raises(ValueError):
            cls().add_cell((1,), rank=2)
    p, j = CombinatorialComplex(), JCC()
    for cc in (p, j):
        cc.add_cell((0, 1), rank=1)
        cc.add_cell((0, 1, 2), rank=2, label=3)
    assert p.cells.hyperedge_dict == j.cells.hyperedge_dict
    assert p.number_of_cells() == j.number_of_cells() == 5


@pytest.mark.parametrize("N_,d_min,d_max", [(4, 3, 3), (7, 2, 4), (20, 3, 3)])
def test_cell_spec_equals_jax(N_, d_min, d_max):
    p, j = cells.get_spec(N_, d_min, d_max), jcells.get_spec(N_, d_min, d_max)
    assert (p.num_edges, p.num_cells) == (j.num_edges, j.num_cells)
    assert cells.rank2_dim(N_, d_min, d_max) == jcells.rank2_dim(N_, d_min, d_max)
    np.testing.assert_array_equal(p.edge_uv, j.edge_uv)
    assert p.cells == j.cells and p.cell_col == j.cell_col and p.edge_row == j.edge_row
    assert cells.n_nodes_from_edges(p.num_edges) == jcells.n_nodes_from_edges(j.num_edges) == N_


# ------------------------------------------------------------ sampler --


@pytest.mark.parametrize("n", [20, 49, 361])
def test_cc_eval_tractable_equals_jax(n):
    cfg = {"data": {"max_node_num": n, "d_min": 3, "d_max": 3}, "sample": {}}
    want = JSampler(JAttrDict(cfg), log=False)._cc_eval_tractable(JAttrDict(cfg))
    assert psampler.cc_eval_tractable(AttrDict(cfg)) == want == (n < 361)


TN, TB, TF = 8, 4, 5


def tiny_config(sample=None, folder="./"):
    """A tiny graph config with community_small's eval fields, 10 steps."""
    return AttrDict({
        "data": {"data": "tiny", "batch_size": TB, "max_node_num": TN, "max_feat_num": TF,
                 "test_split": 0.2, "init": "deg", **{k: v for k, v in WORKER_KWARGS.items()
                                                      if k != "N"},
                 "lifting_procedure": "path_based", "lifting_procedure_kwargs": "basic"},
        "sde": {k: {"type": "VP", "beta_min": 0.1, "beta_max": 1.0, "num_scales": 10}
                for k in ("x", "adj")},
        "model": {"x": "ScoreNetworkX", "adj": "ScoreNetworkA", "conv": "GCN",
                  "num_heads": 2, "depth": 2, "adim": 8, "nhid": 8,
                  "num_layers": 3, "num_linears": 2, "c_init": 2, "c_hid": 4,
                  "c_final": 2, "use_bn": False},
        "sampler": {"predictor": "Euler", "corrector": "Langevin", "snr": 0.05,
                    "scale_eps": 0.7, "n_steps": 1},
        "sample": {"use_ema": False, "noise_removal": True, "probability_flow": False,
                   "eps": 1e-4, "seed": 12, **(sample or {})},
        "seed": 3, "folder": folder,
    })


def tiny_adjs(count, seed):
    return community_small_adjs(count, seed, max_node_num=TN + 12)[:, :TN, :TN]


PROTOCOL = [(5, {}), (5, {"divide_batch": 2}), (9, {"divide_batch": 2, "max_samples": 3}),
            (3, {"max_samples": 100}), (2, {"eval": False})]


@pytest.mark.parametrize("n_test,sample", PROTOCOL, ids=[str(p) for p in PROTOCOL])
def test_sampler_protocol_equals_jax(n_test, sample, tmp_path, monkeypatch):
    """Rounds and kept graphs as the JAX formula gives them
    (ccsd_tpu/sampling/sampler.py:244-258, 381-383), node counts drawn from
    the train split as JAX ``init_flags`` draws them, and the result keys
    of the JAX sampler's evaluation."""
    cfg = tiny_config(sample, str(tmp_path))
    train, test = tiny_adjs(10, 0), tiny_adjs(n_test, 1)
    rounds = []
    real = psampler.init_flags
    monkeypatch.setattr(psampler, "init_flags",
                        lambda *a: rounds.append(a[1]) or real(*a))
    res = psampler.Sampler(cfg, train, test, device="cpu", log=False).sample()

    batch_size = TB  # the JAX formula, as written there
    if sample.get("divide_batch"):
        batch_size //= int(sample["divide_batch"])
    n_rounds = max(1, math.ceil(n_test / batch_size))
    if sample.get("max_samples"):
        n_rounds = min(n_rounds, max(1, math.ceil(int(sample["max_samples"]) / batch_size)))
    assert rounds == [batch_size] * n_rounds
    kept = min(n_test, n_rounds * batch_size)
    assert res["adj"].shape == (kept, TN, TN) and res["finite"]

    graphs = [nx.from_numpy_array(a) for a in train]
    rng = np.random.default_rng(int(cfg.sample.seed))
    jcfg = JAttrDict({"data": {"max_node_num": TN, "batch_size": batch_size}})
    want = np.concatenate([jinit_flags(graphs, jcfg, batch_size, rng=rng)
                           for _ in range(n_rounds)])[:kept]
    np.testing.assert_array_equal(res["flags"], want)

    saved = np.load(tmp_path / "samples" / "tiny" / "samples.npz")
    for k in ("adj", "x", "flags"):
        np.testing.assert_array_equal(saved[k], res[k])
    if not sample.get("eval", True):
        assert "mmd" not in res and "cc_mmd" not in res
        return
    assert list(res["mmd"]) == jstats.load_eval_settings()[0]
    assert list(res["cc_mmd"]) == jcc_stats.load_cc_eval_settings()[0]
    assert res["mmd"] == stats.eval_graph_list(
        adjs_to_graphs(test), adjs_to_graphs(res["adj"]), *stats.load_eval_settings())
    assert all(math.isfinite(v) for v in (*res["mmd"].values(), *res["cc_mmd"].values()))


def test_sampler_skips_the_intractable_lift_and_logs_it(tmp_path, capsys):
    cfg = tiny_config({"cc_eval_max_cells": 10}, str(tmp_path))
    res = psampler.Sampler(cfg, tiny_adjs(6, 0), tiny_adjs(2, 1), device="cpu").sample()
    assert res["cc_mmd"] is None and len(res["mmd"]) == 4
    out = capsys.readouterr().out
    assert "lifted-CC eval skipped: 56 candidate cells at N=8" in out
    assert f"{'degree':9s} : {res['mmd']['degree']:.6f}" in out


def test_cli_sample_prints_mmd_and_cc_mmd(tmp_path, capsys):
    """``cli --type sample`` scores the protocol's graphs against the test
    split of the same dataset (the first int(test_split M) graphs) and
    prints both dicts."""
    import yaml

    from ccsd_tpu_torch import cli

    (tmp_path / "config").mkdir()
    with open(tmp_path / "config" / "tiny.yaml", "w") as f:
        yaml.safe_dump(tiny_config().to_dict(), f)
    adjs = tiny_adjs(15, 2)
    np.save(tmp_path / "adjs.npy", adjs)
    out = tmp_path / "out.npz"
    assert cli.main(["--type", "sample", "--config", "tiny", "--folder", str(tmp_path),
                     "--device", "cpu", "--train-adjs", str(tmp_path / "adjs.npy"),
                     "--out", str(out)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    test = adjs[:3]
    assert report["samples"] == 3 and report["finite"]
    got = np.load(out)["adj"]
    assert report["mmd"] == stats.eval_graph_list(
        adjs_to_graphs(test), adjs_to_graphs(got), *stats.load_eval_settings())
    ccs = [convert_graphs_to_CCs(adjs_to_graphs(a), **dict(LIFT, max_nb_nodes=TN))
           for a in (test, got)]
    assert report["cc_mmd"] == cc_stats.eval_CC_list(*ccs, dict(WORKER_KWARGS, N=TN))
    assert report["eval_seconds"] > 0
