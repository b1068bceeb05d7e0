"""Static combinatorial-complex index structures.

Port of ccsd_tpu/ops/cells.py: ``rank2_dim``, ``edge_index``,
``ComplexSpec`` (the index maps, and the edge endpoints and cell membership
the rank-2 masks of ``ops/masks.py`` gather with), ``get_spec`` (full
enumeration only) and ``n_nodes_from_edges``.  Conventions (those of the reference):

* edges are the C(N,2) 2-subsets of [0..N) in ``itertools.combinations``
  (lexicographic) order -> row index of the rank-2 incidence matrix;
* rank-2 cells are all k-subsets for k in [d_min, d_max], enumerated for
  increasing k and lexicographically within k -> column index.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from itertools import combinations
from math import comb

import numpy as np


@functools.lru_cache(maxsize=32)
def rank2_dim(N: int, d_min: int, d_max: int) -> tuple[int, int]:
    """(rows, cols) of the rank-2 incidence matrix."""
    rows = (N * (N - 1)) // 2
    cols = sum(comb(N, k) for k in range(d_min, d_max + 1))
    return rows, cols


@functools.lru_cache(maxsize=8)
def edge_index(N: int) -> np.ndarray:
    """(E, 2) int32 array of edge endpoints in lexicographic order."""
    return np.array(list(combinations(range(N), 2)), dtype=np.int32).reshape(-1, 2)


@dataclass(frozen=True)
class ComplexSpec:
    """Index structure of the rank-2 combinatorial complexes on N nodes with
    cells of d_min..d_max nodes: E = C(N, 2) edge rows, K cell columns."""

    N: int
    d_min: int
    d_max: int
    num_edges: int = field(init=False)
    num_cells: int = field(init=False)

    def __post_init__(self):
        E, K = rank2_dim(self.N, self.d_min, self.d_max)
        object.__setattr__(self, "num_edges", E)
        object.__setattr__(self, "num_cells", K)

    @functools.cached_property
    def edge_uv(self) -> np.ndarray:
        return edge_index(self.N)

    @property
    def edge_u(self) -> np.ndarray:
        return self.edge_uv[:, 0]

    @property
    def edge_v(self) -> np.ndarray:
        return self.edge_uv[:, 1]

    @functools.cached_property
    def cells(self) -> list[tuple[int, ...]]:
        """All rank-2 cells in column order."""
        out: list[tuple[int, ...]] = []
        for k in range(self.d_min, self.d_max + 1):
            out.extend(combinations(range(self.N), k))
        return out

    @functools.cached_property
    def cell_col(self) -> dict[frozenset, int]:
        return {frozenset(c): j for j, c in enumerate(self.cells)}

    @functools.cached_property
    def edge_row(self) -> dict[frozenset, int]:
        return {
            frozenset((int(u), int(v))): i
            for i, (u, v) in enumerate(self.edge_uv)
        }

    @functools.cached_property
    def cell_mask(self) -> np.ndarray:
        """(K, N) float32 0/1: cell column j holds node n."""
        M = np.zeros((self.num_cells, self.N), dtype=np.float32)
        for j, c in enumerate(self.cells):
            M[j, list(c)] = 1.0
        return M


@functools.lru_cache(maxsize=16)
def get_spec(N: int, d_min: int, d_max: int) -> ComplexSpec:
    return ComplexSpec(N, d_min, d_max)


def n_nodes_from_edges(nb_edges: int) -> int:
    """Invert E = N(N-1)/2."""
    return int((1 + np.sqrt(1 + 8 * nb_edges)) / 2)
