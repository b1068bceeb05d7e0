"""Cleaned graphs from adjacency arrays: the counterpart of ``adjs_to_graphs``
(ccsd_tpu/eval/stats.py:151-161) without networkx.

The JAX package builds ``nx.from_numpy_array(adj)``, removes self-loops,
then isolated nodes, and gives a graph left with no node the single node
labelled 1.  Here a graph is the 0/1 adjacency of the surviving nodes in
ascending index order (the order networkx leaves them in) and their labels
in the original array.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class Graph(NamedTuple):
    """A simple undirected graph: ``adj`` (n, n) int64 0/1, symmetric, zero
    diagonal; ``nodes`` (n,) the labels of its rows."""

    adj: np.ndarray
    nodes: np.ndarray

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)


def adj_to_graph(adj: np.ndarray) -> Graph:
    """One (N, N) 0/1 adjacency -> its cleaned graph.  An entry on either
    side of the diagonal makes the edge, as ``nx.from_numpy_array`` does for
    an undirected graph; any value other than 0 or 1 raises (the graph
    statistics count edges, and the spectrum would weight them)."""
    a = np.asarray(adj)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"expected a square adjacency, got shape {a.shape}")
    if not np.isin(a, (0, 1)).all():
        raise ValueError("adjacency values must be 0 or 1")
    a = (a != 0) | (a != 0).T
    np.fill_diagonal(a, False)
    keep = np.flatnonzero(a.any(1))
    if not len(keep):
        return Graph(np.zeros((1, 1), np.int64), np.array([1]))
    return Graph(a[np.ix_(keep, keep)].astype(np.int64), keep)


def adjs_to_graphs(adjs) -> List[Graph]:
    """(B, N, N) adjacencies -> B cleaned graphs."""
    return [adj_to_graph(a) for a in np.asarray(adjs)]


def edge_list(g: Graph) -> np.ndarray:
    """(m, 2) int32 edges (u < v) of a graph, in row-major order."""
    u, v = np.nonzero(np.triu(g.adj, 1))
    return np.stack([u, v], 1).astype(np.int32)
