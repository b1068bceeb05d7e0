"""Graphs to lifted combinatorial complexes, and CCs to dense incidence.

Port of ccsd_tpu/data/cc_codec.py: ``create_incidence_1_2`` (:34-79,
full enumeration only), ``CC_to_incidence_matrices`` (:82-128),
``cc_from_incidence`` (:131-205), ``pad_adjs`` (:208-223), ``pad_rank2``
(:226-259), ``get_global_cc_properties`` (:262-271), ``ccs_to_tensors``
(:274-306, full enumeration), ``convert_CC_to_graphs`` (:324-338) and
``convert_graphs_to_CCs`` (:341-404), these two on the cleaned graphs of
``eval.graphs`` in place of networkx graphs; all without the molecule
attributes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ccsd_tpu_torch.data.complex import CombinatorialComplex
from ccsd_tpu_torch.data.lifts import path_based_lift_CC
from ccsd_tpu_torch.eval.graphs import Graph, edge_list
from ccsd_tpu_torch.ops.cells import get_spec, n_nodes_from_edges


def create_incidence_1_2(
    N: int,
    A: np.ndarray,
    d_min: int,
    d_max: int,
    two_rank_cells: Dict[frozenset, Dict[str, Any]],
) -> np.ndarray:
    """Rank-1 -> rank-2 incidence matrix from A and the rank-2 cell dict,
    columns in the reference enumeration for (N, d_min, d_max)."""
    spec = get_spec(N, d_min, d_max)
    A = np.asarray(A)
    if not two_rank_cells:
        f = 1
        attributes_names: List[str] = []
    else:
        first = two_rank_cells[next(iter(two_rank_cells))]
        attributes_names = [k for k in first.keys() if k != "weight"]
        f = max(1, len(attributes_names))
    F = np.zeros((spec.num_edges, spec.num_cells, f), dtype=np.float32)
    for c, attrs in two_rank_cells.items():
        if frozenset(c) not in spec.cell_col:
            # cells outside the configured universe are dropped (the
            # reference raises a KeyError here)
            continue
        j = spec.cell_col[frozenset(c)]
        combi = tuple(c)
        for k in range(len(combi) - 1):
            for l in range(k + 1, len(combi)):
                if A[combi[k], combi[l]].any() or A[combi[l], combi[k]].any():
                    i = spec.edge_row[frozenset((combi[k], combi[l]))]
                    if not attributes_names:
                        F[i, j, 0] = 1.0
                    else:
                        for attr_id, attr in enumerate(attributes_names):
                            F[i, j, attr_id] = attrs[attr]
    if F.shape[-1] == 1:
        F = F[..., 0]
    return F


def CC_to_incidence_matrices(
    CC: CombinatorialComplex,
    d_min: Optional[int],
    d_max: Optional[int],
    N: Optional[int] = None,
) -> List[np.ndarray]:
    """CC -> [X, A, F] dense matrices."""
    if not CC.cells.hyperedge_dict:
        return [np.array([]), np.array([]), np.array([])]

    nodes = CC.cells.hyperedge_dict[0]
    if N is None:
        N = len(nodes)
    first = nodes[next(iter(nodes))] if nodes else {}
    attributes_names = [k for k in first.keys() if k != "weight"]
    f = max(1, len(attributes_names))
    X = np.zeros((N, f), dtype=np.float32)
    for k in nodes:
        node = tuple(k)[0]
        if not attributes_names:
            X[node, 0] = 1
        else:
            for attr_id, attr in enumerate(attributes_names):
                X[node, attr_id] = nodes[k][attr]

    if 1 not in CC.cells.hyperedge_dict:
        return [X, np.array([]), np.array([])]
    edges = CC.cells.hyperedge_dict[1]
    first = edges[next(iter(edges))] if edges else {}
    attributes_names = [k for k in first.keys() if k != "weight"]
    f = max(1, len(attributes_names))
    A = np.zeros((N, N, f), dtype=np.float32)
    for k in edges:
        u, v = tuple(k)
        if not attributes_names:
            A[u, v, 0] = A[v, u, 0] = 1.0
        else:
            for attr_id, attr in enumerate(attributes_names):
                A[u, v, attr_id] = A[v, u, attr_id] = edges[k][attr]
    if A.shape[-1] == 1:
        A = A[..., 0]

    if 2 not in CC.cells.hyperedge_dict:
        return [X, A, np.array([])]
    rank2 = CC.cells.hyperedge_dict[2]
    d_min = min(len(c) for c in rank2) if d_min is None else d_min
    d_max = min(len(c) for c in rank2) if d_max is None else d_max
    F = create_incidence_1_2(N, A, d_min, d_max, rank2)
    return [X, A, F]


def cc_from_incidence(incidence_matrices: Sequence[np.ndarray], d_min: int,
                      d_max: int) -> CombinatorialComplex:
    """[X (N, F), A (N, N), F (E, K)] -> CC: a node per nonzero row of X
    (attributes ``label_j``), an edge per nonzero A[i, j] above the
    diagonal (``label``), a rank-2 cell per nonzero column of F, labelled
    with the entry of largest magnitude (``label``)."""
    CC = CombinatorialComplex()
    mats = [np.asarray(m) for m in incidence_matrices]
    if not mats:
        return CC
    X = mats[0]
    N = X.shape[0]
    for i in np.flatnonzero(X.any(1)):
        CC.add_cell((int(i),), rank=0,
                    **{f"label_{j}": float(X[i, j]) for j in range(X.shape[1])})
    if len(mats) == 1:
        return CC
    A = mats[1]
    if A.ndim > 2:
        raise NotImplementedError("multi-channel adjacencies (molecules) are not ported")
    for i, j in zip(*np.nonzero(np.triu(A, 1))):
        CC.add_cell((int(i), int(j)), rank=1, label=float(A[i, j]))
    if len(mats) == 2:
        return CC
    F = mats[2]
    cells = get_spec(N, d_min, d_max).cells
    for col in np.flatnonzero(F.any(0)):
        row = int(np.argmax(np.abs(F[:, col])))
        CC.add_cell(frozenset(cells[col]), 2, label=float(F[row, col]))
    if len(mats) == 3:
        return CC
    raise NotImplementedError("Combinatorial Complexes of dimension > 2 not implemented")


def pad_adjs(ori_adj: np.ndarray, node_number: int) -> np.ndarray:
    """Zero-pad an adjacency matrix to node_number."""
    a = np.asarray(ori_adj)
    if not a.size:
        return np.zeros((node_number, node_number), dtype=np.float32)
    ori_len = a.shape[-1]
    if ori_len > node_number:
        raise ValueError(
            f"Original number of nodes {ori_len} is greater (>) than the "
            f"desired number of nodes after padding {node_number}"
        )
    out = np.zeros((node_number, node_number), dtype=a.dtype)
    out[:ori_len, :ori_len] = a
    return out


def pad_rank2(
    ori_rank2: np.ndarray, node_number: int, d_min: int, d_max: int
) -> np.ndarray:
    """Re-index a rank-2 incidence matrix from its native N to node_number:
    edge rows and cell columns renumbered through the two specs' maps."""
    r = np.asarray(ori_rank2)
    big = get_spec(node_number, d_min, d_max)
    if not r.size:
        return np.zeros((big.num_edges, big.num_cells), dtype=np.float32)
    ori_len = n_nodes_from_edges(r.shape[-2] if r.ndim >= 2 else r.shape[0])
    if ori_len == node_number:
        return r
    if ori_len > node_number:
        raise ValueError(
            f"Original number of nodes {ori_len} is greater (>) than the "
            f"desired number of nodes after padding {node_number}"
        )
    small = get_spec(ori_len, d_min, d_max)
    row_map = np.array(
        [big.edge_row[frozenset((int(u), int(v)))] for u, v in small.edge_uv],
        dtype=np.int64,
    )
    col_map = np.array(
        [big.cell_col[frozenset(c)] for c in small.cells], dtype=np.int64
    )
    out = np.zeros((big.num_edges, big.num_cells), dtype=np.float32)
    out[np.ix_(row_map, col_map)] = r
    return out


def get_global_cc_properties(ccs: List[CombinatorialComplex]) -> Tuple[int, int, int]:
    """(max_node_num, d_min, d_max) over a CC list."""
    max_node_num = max(len(cc.cells.hyperedge_dict.get(0, [])) for cc in ccs)
    sizes = [[len(c) for c in cc.cells.hyperedge_dict.get(2, [])] for cc in ccs]
    return max_node_num, min(min(s) for s in sizes), max(max(s) for s in sizes)


def ccs_to_tensors(cc_list: List[CombinatorialComplex], max_node_num: Optional[int] = None,
                   d_min: Optional[int] = None, d_max: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """CCs -> (adjs (B, N, N), rank2 (B, E, K)) float32, each CC's own
    incidence padded to max_node_num (default: the list's properties)."""
    if max_node_num is None or d_min is None or d_max is None:
        max_node_num, d_min, d_max = get_global_cc_properties(cc_list)
    adjs, rank2s = [], []
    for cc in cc_list:
        _, adj, rank2 = CC_to_incidence_matrices(cc, d_min, d_max)
        adjs.append(pad_adjs(adj, max_node_num))
        rank2s.append(pad_rank2(rank2, max_node_num, d_min, d_max))
    return np.asarray(adjs, dtype=np.float32), np.asarray(rank2s, dtype=np.float32)


def convert_CC_to_graphs(ccs: List[CombinatorialComplex]) -> List[Graph]:
    """CCs -> their 1-skeleton graphs: every rank-0 cell a node (isolated
    ones too), in ascending label order, and every rank-1 cell an edge."""
    graphs = []
    for cc in ccs:
        nodes = sorted({v for node in cc.cells.hyperedge_dict.get(0, {}) for v in node})
        row = {v: i for i, v in enumerate(nodes)}
        adj = np.zeros((len(nodes), len(nodes)), np.int64)
        for edge in cc.cells.hyperedge_dict.get(1, {}):
            u, v = (row[w] for w in edge)
            adj[u, v] = adj[v, u] = 1
        graphs.append(Graph(adj, np.asarray(nodes, np.int64)))
    return graphs


def convert_graphs_to_CCs(
    graphs: List[Graph],
    lifting_procedure: Optional[str] = None,
    lifting_procedure_kwargs=None,
    **kwargs,
) -> List[CombinatorialComplex]:
    """Graphs -> CCs, optionally lifted to rank 2 by paths.

    The dense codec indexes rows by node label, so the JAX package
    relabels a graph 0..n-1 in sorted order where its labels are not
    contiguous (a generated graph after isolated-node removal, or the empty
    one's single node 1).  A graph's rows are its labels in ascending
    order, so that relabelling gives each node its row index, which is the
    label here.  ``lifting_procedure_kwargs: basic`` takes sources
    0..``max_nb_nodes`` - 1 (default: the largest graph's node count) and
    paths of 3 nodes.  The cycles lift raises ``NotImplementedError``.
    """
    ccs = []
    for graph in graphs:
        CC = CombinatorialComplex()
        for node in range(graph.num_nodes):
            CC.add_cell((node,), rank=0)
        for u, v in edge_list(graph):
            CC.add_cell((int(u), int(v)), rank=1)

        if lifting_procedure is not None:
            kw = lifting_procedure_kwargs
            if kw is None:
                kw = {}
            if lifting_procedure == "path_based":
                if isinstance(kw, str):
                    if kw == "basic":
                        max_nb_nodes = kwargs.get(
                            "max_nb_nodes",
                            max(g.num_nodes for g in graphs),
                        )
                        kw = {
                            "sources_nodes": list(range(max_nb_nodes)),
                            "path_length": 3,
                        }
                    else:
                        raise NotImplementedError(
                            f"Lifting procedure kwargs {kw} not implemented"
                        )
                CC = path_based_lift_CC(CC, **kw)
            elif lifting_procedure == "cycles":
                raise NotImplementedError(
                    "the cycles lift (ccsd_tpu/data/lifts.py:63-74, ego_small's) is "
                    "not ported: it needs a cycle basis (ROADMAP.md, Queue A)"
                )
            else:
                raise NotImplementedError(
                    f"Lifting procedure {lifting_procedure} not implemented"
                )
        ccs.append(CC)
    return ccs
