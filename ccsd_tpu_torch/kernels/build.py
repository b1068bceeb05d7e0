"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each source in ``ccsd_tpu_torch/csrc`` exposes a plain C function, so it
compiles in seconds without PyTorch's headers.  Libraries go to
``build/kernels/`` at the repo root (listed in .gitignore), named by a hash
of the source, the headers it includes (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  Nothing
is built at import time: the first launch builds, or :func:`build_all`
builds every kernel at once, one nvcc process per source, all started
together.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of each kernel's library, {symbol: argtypes}, the launcher
# first; every entry point returns an int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "gcn_aggregate": {
        # x, adj, degrees, w, b, out, B, N, F_in, F_out, rows per block,
        # add_loop, loop, stream
        "gcn_aggregate_run": [_P] * 6 + [_I] * 6 + [_F, _P],
        # bf16, a whole graph (N <= 64): x, adj, w, b, out, B, N, F_in,
        # F_out, add_loop, loop, stream
        "gcn_aggregate_bf16_run": [_P] * 5 + [_I] * 5 + [_F, _P],
        # N, F_in, F_out, rows per block -> shared bytes of a block
        "gcn_aggregate_smem": [_I] * 4,
    },
    "gcn_degrees": {
        # adj, degrees, B, C, N, adj strides (b, c, n, m), add_loop, loop, stream
        "gcn_degrees_run": [_P, _P, _I, _I, _I] + [_L] * 4 + [_I, _F, _P],
    },
    "gmh_attention": {
        # x, adj, wq, bq, wk, bk, wv, bv, v_out, a_out,
        # B, C, N, F_in, attn_dim, F_out, heads, head_dim,
        # adj strides (b, c, n, m), score_div, add_loop, loop, stream
        "gmh_attention_f32": [_P] * 10 + [_I] * 8 + [_L] * 4 + [_F, _I, _F, _P],
        # the same over bf16 tensors (N <= 64)
        "gmh_attention_bf16": [_P] * 10 + [_I] * 8 + [_L] * 4 + [_F, _I, _F, _P],
        # N, F_in, attn_dim, F_out, heads -> shared bytes of a block
        "gmh_attention_smem": [_I] * 5,
        # above N = 64: x, adj, degrees, wq, bq, wk, bk, wv, bv, qk scratch,
        # v_out, B, C, N, F_in, attn_dim, F_out, channels per block, adj
        # strides (b, c, n, m), add_loop, loop, stream
        "gmh_projection_run": [_P] * 11 + [_I] * 7 + [_L] * 4 + [_I, _F, _P],
        # N, F_in, attn_dim, F_out, channels per block -> shared bytes
        "gmh_projection_smem": [_I] * 5,
        # q, k, tile pairs, a_out, B, C, N, attn_dim, heads, head_dim,
        # channels per block, pairs, q strides (b, c, n), k strides (b, c, n),
        # score_div, stream
        "gmh_tiled_scores_run": [_P] * 4 + [_I] * 8 + [_L] * 6 + [_F, _P],
        # attn_dim, channels per block -> shared bytes of a block
        "gmh_tiled_scores_smem": [_I] * 2,
    },
    "channel_agg": {
        # adj, x, degrees, out, B, C, N, F, adj strides (b, c, n, m),
        # rows per block, channels per block (rows < N), bf16, stream
        "channel_agg_run": [_P] * 4 + [_I] * 4 + [_L] * 4 + [_I, _I, _I, _P],
        # bf16, a whole graph (N <= 64): adj, x, out, B, C, N, F, adj
        # strides, bf16 rounding, stream
        "channel_agg_bf16_run": [_P] * 3 + [_I] * 4 + [_L] * 4 + [_I, _P],
        # N, F, rows per block, channels per block -> shared bytes of a block
        "channel_agg_smem": [_I] * 4,
    },
    "gmh_scores": {
        # q, k, out, B, C, N, attn_dim, heads, head_dim, channels per block,
        # q strides (b, c, n), k strides (b, c, n), score_div, bf16, stream
        "gmh_scores_run": [_P, _P, _P] + [_I] * 7 + [_L] * 6 + [_F, _I, _P],
        # the same over bf16 q, k and map (N <= 64)
        "gmh_scores_bf16_run": [_P, _P, _P] + [_I] * 7 + [_L] * 6 + [_F, _I, _P],
        # N, attn_dim, heads, channels per block, bf16 -> shared bytes of a block
        "gmh_scores_smem": [_I] * 5,
        # above N = 64: q, k, tile pairs, out, B, C, N, attn_dim, heads,
        # head_dim, channels per block, pairs, q strides, k strides,
        # score_div, bf16, stream
        "gmh_tiled_scores_run": [_P] * 4 + [_I] * 8 + [_L] * 6 + [_F, _I, _P],
        # attn_dim, channels per block -> shared bytes of a block
        "gmh_tiled_scores_smem": [_I] * 2,
        # out (blocks x 256), blocks, iterations, stream: the tanhf rate probe
        "gmh_tanh_rate_run": [_P, _I, _I, _P],
    },
    "gcn_aggregate_bwd": {
        # x, adj, w, dL/dout, dx, dadj, partials, out_w (dW then dbias),
        # tickets, B, N, F_in, F_out, add_loop, loop, stream
        "gcn_aggregate_bwd_run": [_P] * 9 + [_I] * 5 + [_F, _P],
        # N, F_in, F_out -> shared bytes of a block
        "gcn_aggregate_bwd_smem": [_I] * 3,
        # B, N -> clusters of a launch
        "gcn_aggregate_bwd_clusters": [_I] * 2,
        # above N = 64: x, adj, degrees, w, dL/dout, dx, dadj, partials,
        # out_w, tickets, B, N, F_in, F_out, rows of a row tile, chunks a
        # pass, add_loop, loop, stream
        "gcn_aggregate_bwd_tiled_run": [_P] * 10 + [_I] * 7 + [_F, _P],
        # N, F_in, F_out, rows of a row tile, chunks a pass, need_adj ->
        # shared bytes of a block
        "gcn_aggregate_bwd_tiled_smem": [_I] * 6,
    },
    "gmh_attention_bwd": {
        # x, adj, wq, bq, wk, bk, wv, bv, dL/dV, dL/dA, dx, dadj, partials of
        # dx, partials of the weights, out_w, tickets, B, C, N, F_in,
        # attn_dim, F_out, heads, head_dim, strides of adj (b, c, n, m), of
        # dL/dA (b, n, m, c) and of dadj (b, c, n, m), score_div, add_loop,
        # loop, stream
        "gmh_attention_bwd_run": [_P] * 16 + [_I] * 8 + [_L] * 12 + [_F, _I, _F, _P],
        # N, F_in, attn_dim, F_out, heads -> shared bytes of a block
        "gmh_attention_bwd_smem": [_I] * 5,
        # B -> clusters of a channel's blocks
        "gmh_attention_bwd_clusters": [_I],
        # above N = 64: dL/dA, adj, gm out, ac out (or null), B, C, N,
        # strides of dL/dA (b, n, m, c) and of adj (b, c, n, m), stream
        "gmh_bwd_layout_run": [_P] * 4 + [_I] * 3 + [_L] * 8 + [_P],
        # Q | K, gm, gQ | gK out, partials of gK, B, C, N, attn_dim, heads,
        # head_dim, score_div, stream
        "gmh_score_grad_run": [_P] * 4 + [_I] * 6 + [_F, _P],
        # attn_dim, heads -> shared bytes of a block (0: not taken)
        "gmh_score_grad_smem": [_I] * 2,
        # N, attn_dim, heads -> clusters the card holds at once
        "gmh_score_grad_max_clusters": [_I] * 3,
        # x, adjacency rows (adj or ac), degrees, wq, wk, wv, gQ | gK,
        # dL/dV, dx, dadj, partials of dx, partials of the weights, out_w,
        # tickets, B, C, N, F_in, attn_dim, F_out, clusters, strides of the
        # adjacency rows (b, c, n) and of dadj (b, c, n, m), add_loop, loop,
        # stream
        "gmh_attention_bwd_tiled_run": [_P] * 14 + [_I] * 7 + [_L] * 7 + [_I, _F, _P],
        # N, F_in, attn_dim, F_out, need_x, need_adj -> shared bytes of a
        # block (0: not taken)
        "gmh_attention_bwd_tiled_smem": [_I] * 6,
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # kernel name -> nvcc output (ptxas -v report)


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(src: str) -> List[str]:
    """``src`` and every file it includes with quotes, transitively,
    resolved beside the including file as nvcc resolves them."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen or not os.path.exists(path):
            continue
        seen.append(path)
        with open(path, "rb") as f:
            todo += [os.path.join(os.path.dirname(path), m.decode())
                     for m in _INCLUDE.findall(f.read())]
    return seen


def _target(name: str) -> Tuple[str, str]:
    """(source, library path): the name hashes the source, the headers it
    includes and the flags, so editing any of them rebuilds."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha1()
    for path in _sources(src):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def bind(name: str, lib_path: str) -> ctypes.CDLL:
    """Load a kernel's library and type its entry points."""
    lib = ctypes.CDLL(lib_path)
    for sym, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def nvcc_parallel(jobs: Dict[object, Tuple[str, str, List[str]]]) -> Dict[object, str]:
    """Compile every job, {key: (source, library, extra flags)}, with
    NVCC_FLAGS, one nvcc process each, all started together; returns
    {key: nvcc output (the ptxas -v report)} and raises naming each job
    that failed."""
    procs = {key: subprocess.Popen([nvcc_path(), *NVCC_FLAGS, *flags, "-o", lib, src],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for key, (src, lib, flags) in jobs.items()}
    logs, errors = {}, []
    for key, p in procs.items():
        logs[key], _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {key} (rc {p.returncode}):\n{logs[key]}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def build_all(names: List[str] | None = None) -> float:
    """Build (or reuse) the named kernels in parallel; returns the seconds."""
    names = list(SIGNATURES) if names is None else names
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        if name in _LIBS:
            continue
        src, out = _target(name)
        if os.path.exists(out):
            _LIBS[name] = bind(name, out)
        else:
            jobs[name] = (src, f"{out}.{os.getpid()}.tmp", [])
    BUILD_LOG.update(nvcc_parallel(jobs))
    for name, (_, tmp, _) in jobs.items():
        out = _target(name)[1]
        os.replace(tmp, out)
        _LIBS[name] = bind(name, out)
    return time.perf_counter() - t0


def kernel_fn(name: str, symbol: str | None = None):
    """A bound C entry point of a kernel's library (its launcher unless
    ``symbol`` names another), built on first use."""
    if name not in _LIBS:
        build_all([name])
    return getattr(_LIBS[name], symbol or next(iter(SIGNATURES[name])))


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {status}")
