"""Datasets as padded numpy adjacencies: node features, the train/test
split, shuffled batches, and node-count flags for sampling.

The card's machine has no networkx, so a dataset is a (M, N, N) array of
padded adjacencies instead of a list of graphs.  Port copies of
ccsd_tpu/data/loader.py: ``init_features`` (:97-124), ``init_flags`` (the
graph branch of :127-145), ``ArrayDataset`` (:160-209, single-process) and
``_split`` (:212-216); with the same seed they give the JAX package's
features, split and batch order exactly, ``ArrayDataset`` over arrays
held on a torch device.  ``community_small_adjs`` and
``grid_adjs`` make such an array by the JAX package's community_small and
grid recipes (ccsd_tpu/data/generators.py:20-48, 77-84, 87-113, 196-225)
with numpy and the standard library only, graph for graph and edge for
edge the graphs ``gen_graph_list`` gives after ``np.random.seed(seed)``.
A CC dataset (community_small_CC, grid_small_CC) is its graph recipe's
adjacencies and the rank-2 incidence of their lift (``lifted_rank2``), as
the JAX package lifts and pads them (generators.py:244-255,
loader.py:270-300), in uint8 where a caller asks (the entries are 0/1:
grid_small_CC's 100 incidences of 1176 × 18,424 take 2.17 GB so, 8.67 GB in
f32).
"""

from __future__ import annotations

import itertools
import random
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


def init_features(init: str, adjs: np.ndarray, nfeat: int = 10) -> np.ndarray:
    """(B, N, nfeat) initial node features: zeros, ones, or the degree one-hot
    (one more class where the largest degree equals nfeat, as the reference
    retries), zero on absent nodes."""
    B, N = adjs.shape[0], adjs.shape[1]
    flags = (np.abs(adjs).sum(-1) > 1e-5).astype(np.float32)
    if init == "zeros":
        feature = np.zeros((B, N, nfeat), dtype=np.float32)
    elif init == "ones":
        feature = np.ones((B, N, nfeat), dtype=np.float32)
    elif init == "deg":
        deg = adjs.sum(-1).astype(np.int64)
        num_classes = nfeat
        if deg.max() >= num_classes:
            if deg.max() == num_classes:  # the reference's +1 retry
                num_classes += 1
            else:
                raise ValueError(f"Max degree ({deg.max()}) and number of classes "
                                 f"({nfeat}) mismatch")
        feature = np.eye(num_classes, dtype=np.float32)[deg]
    else:
        raise NotImplementedError(
            f"{init} not implemented. Please select from [zeros, ones, deg].")
    return feature * flags[..., None]


class ArrayDataset:
    """Shuffled minibatches of aligned arrays, copied once to ``device``
    (the CPU by default) as tensors: a new permutation from
    ``np.random.default_rng(seed)`` every pass, the last batch ragged, each
    batch gathered on the device.  A uint8 array (0/1 incidences) stays
    uint8 there and its batches are cast to float32, so a pass copies only
    its order from the host."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0, device=None):
        self.device = torch.device(device or "cpu")
        self.arrays = [torch.as_tensor(np.asarray(a)).to(self.device) for a in arrays]
        self.n = self.arrays[0].shape[0]
        if any(a.shape[0] != self.n for a in self.arrays):
            raise ValueError("arrays of different lengths")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, ...]]:
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        idx = torch.from_numpy(idx).to(self.device)
        for s in range(0, self.n, self.batch_size):
            b = idx[s:s + self.batch_size]
            yield tuple(a.index_select(0, b).to(torch.float32) if a.dtype == torch.uint8
                        else a.index_select(0, b) for a in self.arrays)


def split(n: int, test_split: float) -> Tuple[slice, slice]:
    """(train, test) slices: the test set is the first int(test_split * n)
    items, as the reference splits."""
    k = int(test_split * n)
    return slice(k, n), slice(0, k)


def init_flags(train_adjs: np.ndarray, batch_size: int,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(batch_size, N) 0/1 flags of training graphs drawn with replacement."""
    rng = rng or np.random.default_rng()
    idx = rng.integers(0, len(train_adjs), batch_size)
    return (np.abs(train_adjs[idx]).sum(-1) > 1e-5).astype(np.float32)


def _components(adj: List[List[int]]) -> List[set]:
    """The node sets of ``nx.connected_components`` in its order, each
    built by its breadth-first search (``_plain_bfs``) node by node, so
    that a set iterates as networkx's does."""
    seen: set = set()
    comps = []
    for v in range(len(adj)):
        if v in seen:
            continue
        comp, level = {v}, [v]
        while level:
            nxt = []
            for u in level:
                for w in adj[u]:
                    if w not in comp:
                        comp.add(w)
                        nxt.append(w)
            level = nxt
        seen.update(comp)
        comps.append(comp)
    return comps


def _subgraph_nodes(comp: set, n: int) -> List[int]:
    """``list(G.subgraph(comp).nodes())`` of a graph on nodes 0..n-1: the
    view keeps the nodes in a set built one at a time, and iterates that set
    where it holds fewer than half the graph's nodes, else the graph's own
    node order."""
    shown = set(v for v in comp)
    return list(shown) if 2 * len(shown) < n else [v for v in range(n) if v in shown]


def n_community(rs: np.random.RandomState, num_communities: int, max_nodes: int,
                p_inter: float = 0.05) -> np.ndarray:
    """(max_nodes', max_nodes') adjacency of ``n_community``
    (ccsd_tpu/data/generators.py:20-48) without networkx.  Community i is
    ``nx.gnp_random_graph(c, 0.7, seed=i)``: one ``random.Random(i).random()``
    per pair of ``itertools.combinations(range(c), 2)``, placed after the
    earlier ones (``disjoint_union_all``).  For each pair of connected
    components, in networkx's order, one ``rs.random_sample()`` per node
    pair may add a bridge; where none does, the first nodes of the two
    are joined."""
    c = max_nodes // num_communities
    n = c * num_communities
    p_bridge = p_inter * 2 / ((num_communities - 1) * c)
    adj: List[List[int]] = [[] for _ in range(n)]  # G._adj, in insertion order
    for i in range(num_communities):
        r, off = random.Random(i), i * c
        for u, v in itertools.combinations(range(c), 2):
            if r.random() < 0.7:
                adj[off + u].append(off + v)
                adj[off + v].append(off + u)
    out = np.zeros((n, n), np.float32)
    for u, nbrs in enumerate(adj):
        out[u, nbrs] = 1.0
    comps = [_subgraph_nodes(comp, n) for comp in _components(adj)]
    for i, nodes1 in enumerate(comps):
        for nodes2 in comps[i + 1:]:
            bridged = False
            for n1 in nodes1:
                for n2 in nodes2:
                    if rs.random_sample() < p_bridge:
                        out[n1, n2] = out[n2, n1] = 1.0
                        bridged = True
            if not bridged:
                out[nodes1[0], nodes2[0]] = out[nodes2[0], nodes1[0]] = 1.0
    return out


def community_small_adjs(num: int, seed: Union[int, np.random.RandomState],
                         max_node_num: int = 20) -> np.ndarray:
    """(num, max_node_num, max_node_num) padded adjacencies of
    community_small as the JAX package generates it (generators.py:196-204):
    ``np.random.seed(seed)`` then ``gen_graph_list("community",
    {"num_communities": [2], "max_nodes": arange(12, 21)}, num)``, drawn
    here from ``np.random.RandomState(seed)`` in the same order, so the
    graphs are the same bit for bit.  ``seed`` may be a RandomState, which
    the draws advance."""
    rs = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    sizes = np.arange(12, 21).tolist()
    out = np.zeros((num, max_node_num, max_node_num), np.float32)
    for g in range(num):
        num_communities = int(rs.choice([2]))  # GraphGenerator: one choice per parameter
        a = n_community(rs, num_communities, int(rs.choice(sizes)))
        out[g, :a.shape[0], :a.shape[0]] = a
    return out


def grid_adjs(num: int, seed: Union[int, np.random.RandomState], max_node_num: int,
              m_range: Sequence[int], n_range: Sequence[int]) -> np.ndarray:
    """(num, max_node_num, max_node_num) padded adjacencies of the grid
    recipes as the JAX package generates them (generators.py:206-225):
    ``np.random.seed(seed)`` then ``gen_graph_list("grid", {"m": m_range,
    "n": n_range}, num)``.  ``GraphGenerator`` draws m, then n, one
    ``np.random.choice`` each in the dict's order, and builds
    ``nx.grid_2d_graph(m, n)``, whose nodes (i, j) networkx numbers
    row-major, i n + j; the edges join (i, j) to (i + 1, j) and to
    (i, j + 1).  No draw is rejected: the recipes set no node bounds and
    every grid has more than one node.  ``seed`` may be a RandomState, which
    the draws advance."""
    rs = seed if isinstance(seed, np.random.RandomState) else np.random.RandomState(seed)
    m_range, n_range = list(m_range), list(n_range)
    out = np.zeros((num, max_node_num, max_node_num), np.float32)
    for g in range(num):
        m, n = int(rs.choice(m_range)), int(rs.choice(n_range))
        if m * n > max_node_num:
            raise ValueError(f"a {m} x {n} grid has more than max_node_num={max_node_num} nodes")
        ids = np.arange(m * n).reshape(m, n)
        for u, v in ((ids[:-1], ids[1:]), (ids[:, :-1], ids[:, 1:])):  # (i+1, j), (i, j+1)
            out[g, u.ravel(), v.ravel()] = out[g, v.ravel(), u.ravel()] = 1.0
    return out


# the generated datasets: (recipe, its parameters, graphs), as the JAX
# package's generate_dataset makes them (generators.py:196-225)
GENERATED = {
    "community_small": (community_small_adjs, {}, 100),
    "community_small_CC": (community_small_adjs, {}, 100),
    "grid_small": (grid_adjs, {"m_range": range(4, 8), "n_range": range(4, 8)}, 100),
    "grid_small_CC": (grid_adjs, {"m_range": range(4, 8), "n_range": range(4, 8)}, 100),
    "grid": (grid_adjs, {"m_range": range(10, 20), "n_range": range(10, 20)}, 100),
}


def generated_adjs(data: str, seed: int, max_node_num: int) -> np.ndarray:
    """The dataset ``data`` (a key of ``GENERATED``) generated from ``seed``
    and padded to ``max_node_num``."""
    recipe, params, num = GENERATED[data]
    return recipe(num, seed, max_node_num, **params)


def lifted_rank2(adjs: np.ndarray, data, dtype=np.float32) -> np.ndarray:
    """(M, E, K) rank-2 incidences of the graphs ``adjs`` lifted by the
    config's ``data.lifting_procedure`` (with ``basic`` kwargs: paths of 3
    nodes from every node of the largest graph), each padded to
    ``data.max_node_num`` with cells of ``data.d_min``..``data.d_max``
    nodes: ``ccs_to_tensors``' incidences, written graph by graph into one
    array of ``dtype``, which must hold each entry exactly."""
    from ccsd_tpu_torch.data.cc_codec import (
        CC_to_incidence_matrices,
        convert_graphs_to_CCs,
        pad_rank2,
    )
    from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
    from ccsd_tpu_torch.ops.cells import get_spec

    ccs = convert_graphs_to_CCs(adjs_to_graphs(adjs),
                                lifting_procedure=data.lifting_procedure,
                                lifting_procedure_kwargs=data.get("lifting_procedure_kwargs"))
    N, d_min, d_max = int(data.max_node_num), int(data.d_min), int(data.d_max)
    spec = get_spec(N, d_min, d_max)
    out = np.zeros((len(ccs), spec.num_edges, spec.num_cells), dtype)
    for i, cc in enumerate(ccs):
        r = pad_rank2(CC_to_incidence_matrices(cc, d_min, d_max)[2], N, d_min, d_max)
        out[i] = r
        if not np.array_equal(out[i], r):
            raise ValueError(f"rank-2 incidence {i} does not fit {np.dtype(dtype).name}")
    return out
