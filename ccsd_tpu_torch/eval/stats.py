"""Graph MMD statistics: degree, clustering, spectral and orbit.

Port of ccsd_tpu/eval/stats.py:20-148 on cleaned adjacency graphs
(``eval.graphs``), without networkx.  Each worker computes what the JAX
package's networkx call gives, value for value, so the histograms are equal
and the MMDs with them:

* degree: ``nx.degree_histogram``, the count of each degree 0..max;
* clustering: ``nx.clustering``, t / (d (d - 1)) with t the node's triangle
  count taken twice, divided as integers, 0 where t = 0;
* spectral: ``nx.normalized_laplacian_matrix``, DH (L DH) with L = D - A and
  DH = 1 / sqrt(d) (0 where d = 0), in float64, in the node order, each
  entry one product of the same two factors; then ``np.linalg.eigvalsh``;
* orbit: the native counter's per-node counts, summed and divided by n.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ccsd_tpu_torch.eval.graphs import Graph
from ccsd_tpu_torch.eval.mmd import compute_mmd, gaussian, gaussian_emd
from ccsd_tpu_torch.eval.orbits import orbit_counts


def degree_worker(g: Graph) -> np.ndarray:
    return np.bincount(g.adj.sum(1))


def degree_stats(graph_ref_list, graph_pred_list, kernel=gaussian_emd, **_) -> float:
    pred = [g for g in graph_pred_list if g.num_nodes > 0]
    sample_ref = [degree_worker(g) for g in graph_ref_list]
    sample_pred = [degree_worker(g) for g in pred]
    return compute_mmd(sample_ref, sample_pred, kernel=kernel)


def normalized_laplacian(g: Graph) -> np.ndarray:
    d = g.adj.sum(1)
    lap = np.diag(d) - g.adj
    with np.errstate(divide="ignore"):
        dh = 1.0 / np.sqrt(d)
    dh[np.isinf(dh)] = 0
    return dh[:, None] * (lap * dh[None, :])


def spectral_worker(g: Graph) -> np.ndarray:
    eigs = np.linalg.eigvalsh(normalized_laplacian(g))
    spectral_pmf, _ = np.histogram(eigs, bins=200, range=(-1e-5, 2), density=False)
    return spectral_pmf / spectral_pmf.sum()


def spectral_stats(graph_ref_list, graph_pred_list, kernel=gaussian_emd, **_) -> float:
    pred = [g for g in graph_pred_list if g.num_nodes > 0]
    sample_ref = [spectral_worker(g) for g in graph_ref_list]
    sample_pred = [spectral_worker(g) for g in pred]
    return compute_mmd(sample_ref, sample_pred, kernel=kernel)


def clustering_coefficients(g: Graph) -> np.ndarray:
    d = g.adj.sum(1)
    t = ((g.adj @ g.adj) * g.adj).sum(1)
    out = np.zeros(g.num_nodes)
    nz = t > 0
    out[nz] = t[nz] / (d[nz] * (d[nz] - 1))
    return out


def clustering_worker(g: Graph, bins: int = 100) -> np.ndarray:
    hist, _ = np.histogram(clustering_coefficients(g), bins=bins, range=(0.0, 1.0),
                           density=False)
    return hist


def clustering_stats(graph_ref_list, graph_pred_list, kernel=gaussian_emd,
                     bins: int = 100, **_) -> float:
    pred = [g for g in graph_pred_list if g.num_nodes > 0]
    sample_ref = [clustering_worker(g, bins) for g in graph_ref_list]
    sample_pred = [clustering_worker(g, bins) for g in pred]
    return compute_mmd(sample_ref, sample_pred, kernel=kernel, sigma=1.0 / 10,
                       distance_scaling=bins)


def orbit_worker(g: Graph) -> np.ndarray:
    """The graph's orbit counts summed over its nodes, divided by n."""
    return orbit_counts(g).sum(axis=0) / g.num_nodes


def orbit_stats_all(graph_ref_list, graph_pred_list, kernel=gaussian, **_) -> float:
    """4-node graphlet-orbit MMD.  The JAX package prints and skips a graph
    whose count fails; here a failure raises (the counter has no failure
    mode on a valid graph, and a skipped graph would change the MMD)."""
    ref = np.array([orbit_worker(g) for g in graph_ref_list if g.num_nodes > 0])
    pred = np.array([orbit_worker(g) for g in graph_pred_list if g.num_nodes > 0])
    return compute_mmd(ref, pred, kernel=kernel, is_hist=False, sigma=30.0)


METHOD_NAME_TO_FUNC = {
    "degree": degree_stats,
    "cluster": clustering_stats,
    "orbit": orbit_stats_all,
    "spectral": spectral_stats,
}


def load_eval_settings():
    """Default generic-graph eval settings."""
    methods = ["degree", "cluster", "orbit", "spectral"]
    kernels = {
        "degree": gaussian_emd,
        "cluster": gaussian_emd,
        "orbit": gaussian,
        "spectral": gaussian_emd,
    }
    return methods, kernels


def eval_graph_list(
    graph_ref_list: List[Graph],
    graph_pred_list: List[Graph],
    methods: Optional[List[str]] = None,
    kernels: Optional[Dict[str, Callable]] = None,
) -> Dict[str, float]:
    """Evaluate generated graphs against a reference set: each MMD rounded
    to 6 decimals."""
    if methods is None:
        methods = ["degree", "cluster", "orbit"]
    if kernels is None:
        kernels = load_eval_settings()[1]
    return {m: round(METHOD_NAME_TO_FUNC[m](graph_ref_list, graph_pred_list, kernels[m]), 6)
            for m in methods}
