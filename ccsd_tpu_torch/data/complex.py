"""Minimal combinatorial-complex container.

Port copy of ccsd_tpu/data/complex.py.

The reference depends on (a patched) TopoNetX ``CombinatorialComplex``
(fixes/combinatorial_complex.py:24-1678), but only ever uses a tiny surface:
``cells.hyperedge_dict[rank][frozenset] -> attr dict``, ``add_cell`` and
``number_of_cells``.  This is a from-scratch implementation of exactly that
surface (TopoNetX is not vendored or copied).
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Iterable


class _HyperEdgeView:
    """Exposes ``hyperedge_dict[rank][frozenset(cell)] -> {attr: value}``."""

    def __init__(self) -> None:
        self.hyperedge_dict: Dict[int, Dict[FrozenSet, Dict[str, Any]]] = {}

    def __len__(self) -> int:
        return sum(len(d) for d in self.hyperedge_dict.values())


class CombinatorialComplex:
    """Rank-indexed cell store with the reference-compatible API."""

    def __init__(self) -> None:
        self.cells = _HyperEdgeView()

    def add_cell(self, cell: Iterable, rank: int, **attr: Any) -> None:
        key = frozenset(cell)
        if rank > 0 and len(key) <= rank - 1:
            raise ValueError(
                f"cell of size {len(key)} cannot have rank {rank}"
            )
        # every cell implies its vertices exist as rank-0 cells (TopoNetX
        # semantics relied on by CC_to_incidence_matrices)
        if rank > 0:
            for v in key:
                self.cells.hyperedge_dict.setdefault(0, {}).setdefault(
                    frozenset((v,)), {"weight": 1}
                )
        d = self.cells.hyperedge_dict.setdefault(rank, {})
        attrs = d.setdefault(key, {})
        if "weight" not in attrs and "weight" not in attr:
            attr = {"weight": 1, **attr}
        attrs.update(attr)

    def number_of_cells(self) -> int:
        return len(self.cells)

    # convenience accessors used by our data/eval layers
    def cells_of_rank(self, rank: int) -> Dict[FrozenSet, Dict[str, Any]]:
        return self.cells.hyperedge_dict.get(rank, {})

    def __repr__(self) -> str:
        sizes = {r: len(d) for r, d in sorted(self.cells.hyperedge_dict.items())}
        return f"CombinatorialComplex(cells per rank: {sizes})"
