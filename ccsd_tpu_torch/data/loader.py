"""Datasets as padded numpy adjacencies: node features, the train/test
split, shuffled batches, and node-count flags for sampling.

The card's machine has no networkx, so a dataset is a (M, N, N) array of
padded adjacencies instead of a list of graphs.  Port copies of
ccsd_tpu/data/loader.py: ``init_features`` (:97-124), ``init_flags`` (the
graph branch of :127-145), ``ArrayDataset`` (:160-209, single-process) and
``_split`` (:212-216); with the same seed they give the JAX package's
features, split and batch order exactly.  ``community_small_adjs`` makes
such an array by the community_small recipe
(ccsd_tpu/data/generators.py:20-48, 196-204): two communities of
``max_nodes // 2`` nodes each, ``max_nodes`` uniform in 12..20, G(n, 0.7)
inside a community and at least one bridge.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


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
    """Shuffled minibatches of aligned numpy arrays: a new permutation from
    ``np.random.default_rng(seed)`` every pass, the last batch ragged."""

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 shuffle: bool = True, seed: int = 0):
        self.arrays = [np.asarray(a) for a in arrays]
        self.n = self.arrays[0].shape[0]
        if any(a.shape[0] != self.n for a in self.arrays):
            raise ValueError("arrays of different lengths")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        idx = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, self.n, self.batch_size):
            b = idx[s:s + self.batch_size]
            yield tuple(a[b] for a in self.arrays)


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


def community_small_adjs(num: int, rng: np.random.Generator,
                         max_node_num: int = 20, p_intra: float = 0.7,
                         p_inter: float = 0.05) -> np.ndarray:
    """(num, max_node_num, max_node_num) two-community graphs."""
    out = np.zeros((num, max_node_num, max_node_num), np.float32)
    for g in range(num):
        c = int(rng.integers(12, 21)) // 2
        n = 2 * c
        a = np.triu(rng.random((n, n)) < p_intra, 1)
        a[:c, c:] = False  # no edges between communities but the bridges
        p_bridge = p_inter * 2 / c
        bridges = np.triu(rng.random((n, n)) < p_bridge, 1)
        bridges[:c, :c] = bridges[c:, c:] = False
        if not bridges.any():
            bridges[0, c] = True
        a = a | bridges
        out[g, :n, :n] = a | a.T
    return out
