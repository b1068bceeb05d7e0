"""Graph -> rank-2 CC lifting by paths.

Port of ``path_based_lift_CC`` and its path helpers
(ccsd_tpu/data/lifts.py:17-60).  The cycles lift (:63-74, ego_small's)
needs a cycle basis and is not ported: ``data.cc_codec`` raises for it.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, FrozenSet, List, Set

from ccsd_tpu_torch.data.complex import CombinatorialComplex


def get_all_paths_from_single_node(
    n: int, g: Dict[int, List[int]], path_length: int
) -> Set[FrozenSet[int]]:
    """All simple paths of exactly path_length nodes starting at n."""
    paths: Set[FrozenSet[int]] = set()
    if path_length == 1:
        paths.add(frozenset([n]))
        return paths
    for v in g[n]:
        for path in get_all_paths_from_single_node(v, g, path_length - 1):
            if n not in path:
                paths.add(frozenset([n]) | path)
    return paths


def get_all_paths_from_nodes(
    nodes: List[int], g: Dict[int, List[int]], path_length: int
) -> Set[FrozenSet[int]]:
    paths: Set[FrozenSet[int]] = set()
    for n in nodes:
        if n in g:
            paths |= get_all_paths_from_single_node(n, g, path_length)
    return paths


def _copy_cc(input_cc: CombinatorialComplex) -> CombinatorialComplex:
    cc = CombinatorialComplex()
    for rank, cells in input_cc.cells.hyperedge_dict.items():
        for cell, attr in cells.items():
            cc.add_cell(cell, rank=rank, **attr)
    return cc


def path_based_lift_CC(
    input_cc: CombinatorialComplex, sources_nodes: List[int], path_length: int
) -> CombinatorialComplex:
    """Lift: every simple path from the source nodes becomes a rank-2 cell."""
    cc = _copy_cc(input_cc)
    graph: Dict[int, List[int]] = defaultdict(list)
    for e in input_cc.cells.hyperedge_dict.get(1, {}):
        u, v = tuple(e)
        graph[u].append(v)
        graph[v].append(u)
    for path in get_all_paths_from_nodes(sources_nodes, graph, path_length):
        cc.add_cell(path, rank=2)
    return cc
