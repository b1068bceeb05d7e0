"""Node-count flags for sampling, from padded numpy adjacencies.

``init_flags`` is the graph branch of ccsd_tpu/data/loader.py:127-145,
taking the training set as a (M, N, N) array instead of networkx graphs
(the card's machine has no networkx).  ``community_small_adjs`` makes such
an array by the community_small recipe (ccsd_tpu/data/generators.py:20-48,
196-204): two communities of ``max_nodes // 2`` nodes each, ``max_nodes``
uniform in 12..20, G(n, 0.7) inside a community and at least one bridge.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
