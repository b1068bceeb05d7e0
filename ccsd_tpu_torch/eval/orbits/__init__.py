"""ctypes binding of the native graphlet-orbit counter.

``graphlet_orbits.cpp`` and ``orbit5_table.inc`` are copies of the JAX
package's (ccsd_tpu/eval/orbits/).  The library is built with
``g++ -O2 -shared -fPIC`` at first use into ``build/orbits/`` at the repo
root (listed in .gitignore), named by a hash of both sources and the flags,
so an edited source is rebuilt and an unchanged one reused.  A failed build
raises with the compiler's output: there is no Python fallback.
``orbit_counts_py`` is a copy of the JAX package's brute-force oracle
(ccsd_tpu/eval/orbits/__init__.py:105-177), for the tests and the smoke.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from itertools import combinations

import numpy as np

from ccsd_tpu_torch.eval.graphs import Graph, edge_list

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(HERE, f) for f in ("graphlet_orbits.cpp", "orbit5_table.inc")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(HERE))),
                         "build", "orbits")
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
NUM_ORBITS = 15  # the 2-, 3- and 4-node graphlets' node orbits


def library_path() -> str:
    h = hashlib.sha1()
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgraphlet_orbits-{h.hexdigest()[:12]}.so")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The counter's library, built on first use; raises if g++ fails."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCES[0]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the orbit counter (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.count_orbits.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.count_orbits.restype = None
    return lib


def orbit_counts(g: Graph) -> np.ndarray:
    """(n, 15) int64 per-node counts of orbits 0-14 (the reference's "orca
    node 4" protocol), rows in the graph's node order."""
    edges = edge_list(g)
    out = np.zeros((g.num_nodes, NUM_ORBITS), np.int64)
    library().count_orbits(g.num_nodes, len(edges), np.ascontiguousarray(edges[:, 0]),
                           np.ascontiguousarray(edges[:, 1]), out.reshape(-1))
    return out


def orbit_counts_py(n: int, edges) -> np.ndarray:
    """Brute-force oracle: classify every connected induced <=4-subset."""
    adj = [set() for _ in range(n)]
    eset = set()
    for u, v in edges:
        if u == v:
            continue
        adj[u].add(v)
        adj[v].add(u)
        eset.add((min(u, v), max(u, v)))
    out = np.zeros((n, 15), np.int64)
    for v in range(n):
        out[v, 0] = len(adj[v])

    def internal(sub):
        return [(a, b) for a, b in combinations(sub, 2)
                if (min(a, b), max(a, b)) in eset]

    def is_connected(sub, es):
        seen = {sub[0]}
        frontier = [sub[0]]
        nbrs = {s: set() for s in sub}
        for a, b in es:
            nbrs[a].add(b)
            nbrs[b].add(a)
        while frontier:
            x = frontier.pop()
            for y in nbrs[x]:
                if y not in seen:
                    seen.add(y)
                    frontier.append(y)
        return len(seen) == len(sub)

    for sub in combinations(range(n), 3):
        es = internal(sub)
        if len(es) < 2 or not is_connected(sub, es):
            continue
        deg = {s: 0 for s in sub}
        for a, b in es:
            deg[a] += 1
            deg[b] += 1
        if len(es) == 2:
            for s in sub:
                out[s, 2 if deg[s] == 2 else 1] += 1
        else:
            for s in sub:
                out[s, 3] += 1

    for sub in combinations(range(n), 4):
        es = internal(sub)
        if len(es) < 3 or not is_connected(sub, es):
            continue
        deg = {s: 0 for s in sub}
        for a, b in es:
            deg[a] += 1
            deg[b] += 1
        ne = len(es)
        maxd = max(deg.values())
        for s in sub:
            if ne == 3:
                orbit = (5 if deg[s] == 2 else 4) if maxd == 2 else (
                    7 if deg[s] == 3 else 6)
            elif ne == 4:
                if maxd == 2:
                    orbit = 8
                else:
                    orbit = 9 if deg[s] == 1 else (11 if deg[s] == 3 else 10)
            elif ne == 5:
                orbit = 13 if deg[s] == 3 else 12
            else:
                orbit = 14
            out[s, orbit] += 1
    return out
