"""Where the time of the two backward kernels goes, on the card.

Times ``gcn_aggregate_bwd`` and ``gmh_attention_bwd`` at community_small's
training shapes (B = 80, N = 20), asking for the gradients the training
path asks for: ScoreNetworkX's first layer (F_in 11, dW and dbias only)
and a later one (F_in 32, with dx), plus a later one with dadj too (off the
path); ScoreNetworkA's first AttentionLayer (C = 2, F_in 11, a contiguous
adjacency, no dx or dadj) and a later one (C = 8, F_in 32, the
channels-last adjacency, with dx and dadj):

* each kernel whole, and with stages removed: a build with
  ``-DGRAD_ABLATE=<mask>`` (``csrc/grad_common.cuh``) puts a zero fill of
  what a stage writes in its place (the loads; the forward's recompute; the
  head scores and gS; each gradient product; the batch and channel sums);
  ``skeleton`` keeps the loads, the degrees, the barriers and the stores;
* ``gmh_attention_bwd`` in other geometries, built from this tree's
  source with one line edited: clusters of 4 and of 2 blocks in place of
  8, and 192 threads a block with five blocks an SM (64 registers a
  thread) in place of 256 threads and four;
* with ``--parent DIR``, a tree unpacked from an earlier commit
  (``git archive <commit> | tar -x -C DIR``): its two kernels the same way,
  each product's FMAs removed by exact edits of its source lines (a
  product's depth set to 0: its outputs are still written, as zeros), its
  loads by an edit of its tile loader, its batch and channel sums (the
  separate ``strided_sum`` launches) by edits of its host code; the script
  stops where a line is not found.  The parent's and this tree's whole
  kernels are timed in turns (parent, this, this, parent).

Each variant is built with the flags of ``ccsd_tpu_torch/kernels/build.py``
into ``build/stage_times_grad/``, all in parallel, and timed as
``chip_smoke.py`` times the kernels (CUDA-graph replay of 200 launches,
CUDA events); this tree's variants run through the wrappers, with the
variant's library bound in place of the kernel's.  Run from the repo root
on a machine with an NVIDIA H100:

    python3 scripts/grad_stage_times.py [--parent DIR [--parent-only]]

Prints the card's name and power limit, one line per measurement and,
last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import math
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccsd_tpu_torch.kernels import build  # noqa: E402
from ccsd_tpu_torch.kernels.gcn import gcn_aggregate_bwd  # noqa: E402
from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention_bwd  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "stage_times_grad")
# the Stage masks of csrc/grad_common.cuh
LOADS, RECOMPUTE, SCORES, GRAD_QK, GRAD_W, GRAD_NX, GRAD_X, GRAD_ADJ, REDUCE, GRAD_Y = (
    1 << i for i in range(10))
GMH_ALL = RECOMPUTE | SCORES | GRAD_QK | GRAD_W | GRAD_NX | GRAD_X | GRAD_ADJ | REDUCE
GCN_ALL = GRAD_Y | GRAD_X | GRAD_W | GRAD_ADJ | REDUCE
VARIANTS = {
    "gcn_aggregate_bwd": {"base": 0, "no_loads": LOADS, "no_grad_y": GRAD_Y,
                          "no_grad_x": GRAD_X, "no_grad_w": GRAD_W, "no_grad_adj": GRAD_ADJ,
                          "no_reduce": REDUCE, "skeleton": GCN_ALL},
    "gmh_attention_bwd": {"base": 0, "no_loads": LOADS, "no_recompute": RECOMPUTE,
                          "no_scores": SCORES, "no_grad_qk": GRAD_QK, "no_grad_w": GRAD_W,
                          "no_grad_nx": GRAD_NX, "no_grad_x": GRAD_X, "no_grad_adj": GRAD_ADJ,
                          "no_reduce": REDUCE, "skeleton": GMH_ALL},
}

# the earlier (one-output-a-thread) kernels' stages, as {stage: [(file, line,
# replacement)]} edits of their sources
_LOADER = ("grad_common.cuh", "dst[r * ldd + c] = src[r * srow + c * scol];",
           "dst[r * ldd + c] = 0.f; (void)src;")
PARENT_EDITS = {
    "gcn_aggregate_bwd": {
        "loads": [_LOADER],
        "y": [("gcn_aggregate_bwd.cu", "N, Fo, Fi, [&](int r, int k) { return sX[r * Fi + k]; },",
               "N, Fo, 0, [&](int r, int k) { return sX[r * Fi + k]; },")],
        "grad_y": [("gcn_aggregate_bwd.cu",
                    "N, Fo, N, [&](int m, int n) { return sA[n * N + m] * sD[n]; },",
                    "N, Fo, 0, [&](int m, int n) { return sA[n * N + m] * sD[n]; },")],
        "grad_x": [("gcn_aggregate_bwd.cu",
                    "N, Fi, Fo, [&](int r, int k) { return sDY[r * Fo + k]; },",
                    "N, Fi, 0, [&](int r, int k) { return sDY[r * Fo + k]; },")],
        "grad_w": [("gcn_aggregate_bwd.cu",
                    "Fi, Fo, N, [&](int f, int n) { return sX[n * Fi + f]; },",
                    "Fi, Fo, 0, [&](int f, int n) { return sX[n * Fi + f]; },"),
                   ("gcn_aggregate_bwd.cu", "for (int n = 0; n < N; ++n) s += sG[n * Fo + c];",
                    "")],
        "grad_adj": [("gcn_aggregate_bwd.cu",
                      "N, N, Fo, [&](int n, int k) { return sG[n * Fo + k]; },",
                      "N, N, 0, [&](int n, int k) { return sG[n * Fo + k]; },")],
        "sums": [("gcn_aggregate_bwd.cu",
                  "return grad::launch_strided_sum(part, out_w, len, B, len, len, 0, s);",
                  "return 0;")],
    },
    "gmh_attention_bwd": {
        "loads": [_LOADER, ("gmh_attention_bwd.cu",
                            "sBias[off + i] = bias[m] ? bias[m][i] : 0.f;",
                            "sBias[off + i] = 0.f;")],
        "recompute": [("gmh_attention_bwd.cu",
                       "N, Fi, N, [&](int r, int k) { return sNorm[r * N + k]; },",
                       "N, Fi, 0, [&](int r, int k) { return sNorm[r * N + k]; },"),
                      ("gmh_attention_bwd.cu",
                       "N, 2 * A, Fi, [&](int r, int k) { return sNX[r * Fi + k]; },",
                       "N, 2 * A, 0, [&](int r, int k) { return sNX[r * Fi + k]; },")],
        "scores": [("gmh_attention_bwd.cu",
                    "for (int j = 0; j < ds; ++j) dot = fmaf(q[j], k[j], dot);",
                    "(void)q; (void)k;")],
        "grad_qk": [("gmh_attention_bwd.cu",
                     "for (int m = 0; m < N; ++m) acc = fmaf(g[r * N + m], sK[m * ldq + col], acc);",
                     "(void)g;"),
                    ("gmh_attention_bwd.cu",
                     "for (int n = 0; n < N; ++n) acc = fmaf(g[n * N + r], sQ[n * ldq + col], acc);",
                     "(void)g;")],
        "grad_w": [("gmh_attention_bwd.cu",
                    "Fi, P, N, [&](int f, int n) { return sNX[n * Fi + f]; },",
                    "Fi, P, 0, [&](int f, int n) { return sNX[n * Fi + f]; },"),
                   ("gmh_attention_bwd.cu", "for (int n = 0; n < N; ++n) acc += sGP[n * P + p];",
                    "")],
        "grad_nx": [("gmh_attention_bwd.cu",
                     "N, Fi, P, [&](int r, int p) { return sGP[r * P + p]; },",
                     "N, Fi, 0, [&](int r, int p) { return sGP[r * P + p]; },")],
        "grad_x": [("gmh_attention_bwd.cu",
                    "N, Fi, N, [&](int m, int n) { return sNorm[n * N + m]; },",
                    "N, Fi, 0, [&](int m, int n) { return sNorm[n * N + m]; },")],
        "grad_adj": [("gmh_attention_bwd.cu",
                      "N, N, Fi, [&](int n, int f) { return sGNX[n * Fi + f]; },",
                      "N, N, 0, [&](int n, int f) { return sGNX[n * Fi + f]; },")],
        "sums": [("gmh_attention_bwd.cu",
                  "e = grad::launch_strided_sum(part_w, out_w, len, B, len, len, 0, s);",
                  "e = 0;"),
                 ("gmh_attention_bwd.cu",
                  "return grad::launch_strided_sum(part_x, dx, B * plane, C, plane, plane,",
                  "return 0; (void)grad::launch_strided_sum(part_x, dx, B * plane, C, plane, "
                  "plane,")],
    },
}
# this tree's gmh_attention_bwd in other geometries, as {variant: [(file,
# line, replacement)]}
_LAUNCH = ("gmh_attention_bwd.cu", "gmh_attention_bwd_kernel<<<grid, kThreads, smem",
           "gmh_attention_bwd_kernel<<<grid, 192, smem")
_BOUNDS = ("gmh_attention_bwd.cu", "__launch_bounds__(kThreads, 4)", "__launch_bounds__(192, 5)")
GEOMETRIES = {
    "cluster4": [("grad_common.cuh", "constexpr int kCluster = 8;", "constexpr int kCluster = 4;")],
    "cluster2": [("grad_common.cuh", "constexpr int kCluster = 8;", "constexpr int kCluster = 2;")],
    "threads192": [_LAUNCH, _BOUNDS],
}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
PARENT_SYMBOLS = {  # the earlier C entry points
    "gcn_aggregate_bwd": ("gcn_aggregate_bwd_run", [_P] * 8 + [_I] * 5 + [_F, _P]),
    "gmh_attention_bwd": ("gmh_attention_bwd_run",
                          [_P] * 15 + [_I] * 8 + [_L] * 12 + [_F, _I, _F, _P]),
}

# (name, B, N, F_in, F_out, loop, need_x, need_adj): chip_smoke.gcn_bwd_inputs
GCN_CASES = [("x.layers.0", 80, 20, 11, 32, 1.0, False, False),
             ("x.layers.1", 80, 20, 32, 32, 1.0, True, False),
             ("x.layers.1 with dadj", 80, 20, 32, 32, 1.0, True, True)]
# (name, B, C, N, F_in, attn, F_out, H, need_x, need_adj): chip_smoke.gmh_bwd_inputs
# (layer 0: a contiguous adjacency; later layers: channels-last)
GMH_CASES = [("adj.layers.0", 80, 2, 20, 11, 32, 32, 4, False, False),
             ("adj.layers.1", 80, 8, 20, 32, 32, 32, 4, True, True)]


def edited_copy(src_dir, kname, vdir, edits):
    """kname.cu and the headers of src_dir copied into vdir, with the
    (file, line, replacement) edits made; returns the copy's source."""
    shutil.rmtree(vdir, ignore_errors=True)
    os.makedirs(vdir)
    for path in glob.glob(os.path.join(src_dir, "*.cuh")) + [
            os.path.join(src_dir, f"{kname}.cu")]:
        shutil.copy(path, vdir)
    for fname, old, new in edits:
        path = os.path.join(vdir, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{kname}: line {old!r} not found once in {path}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return os.path.join(vdir, f"{kname}.cu")


def parent_sources(parent_dir):
    """{(kernel, variant): source path}: the earlier sources with the stages
    of each variant edited out, each variant in a directory of its own with
    the headers it includes."""
    src_dir = os.path.join(parent_dir, "ccsd_tpu_torch", "csrc")
    out = {}
    for kname, stages in PARENT_EDITS.items():
        variants = {"base": [], **{f"no_{s}": [s] for s in stages},
                    "skeleton": [s for s in stages if s != "loads"]}
        for variant, removed in variants.items():
            out[(kname, variant)] = edited_copy(
                src_dir, kname, os.path.join(OUT_DIR, "parent_src", f"{kname}_{variant}"),
                [edit for stage in removed for edit in stages[stage]])
    return out


def build_variants(parent_dir, new):
    """{(tree, kernel, variant): library path}, all built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {}
    if new:
        jobs = {("new", kname, variant): (os.path.join(build.CSRC_DIR, f"{kname}.cu"),
                                          os.path.join(OUT_DIR, f"lib{kname}_new_{variant}.so"),
                                          [f"-DGRAD_ABLATE={mask}"])
                for kname, variants in VARIANTS.items() for variant, mask in variants.items()}
        for variant, edits in GEOMETRIES.items():
            src = edited_copy(build.CSRC_DIR, "gmh_attention_bwd",
                              os.path.join(OUT_DIR, "geometry_src", variant), edits)
            jobs[("new", "gmh_attention_bwd", variant)] = (
                src, os.path.join(OUT_DIR, f"libgmh_attention_bwd_new_{variant}.so"), [])
    if parent_dir:
        for (kname, variant), src in parent_sources(parent_dir).items():
            jobs[("parent", kname, variant)] = (
                src, os.path.join(OUT_DIR, f"lib{kname}_parent_{variant}.so"), [])
    logs = build.nvcc_parallel(jobs)
    for (tree, kname, variant) in jobs:
        if variant == "base":
            print(f"ptxas {tree} {kname}: " + " | ".join(
                ln.split("info    : ")[-1].strip()
                for ln in logs[(tree, kname, variant)].splitlines() if "Used" in ln), flush=True)
    return {key: lib for key, (_, lib, _) in jobs.items()}


def parent_launcher(lib_path, kname, args):
    """A call of the earlier kernel's C entry point on the wrapper's
    arguments ``args``, its scratch allocated as its wrapper did."""
    sym, argtypes = PARENT_SYMBOLS[kname]
    fn = getattr(ctypes.CDLL(lib_path), sym)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    new = lambda *s: torch.empty(*s, device="cuda")  # noqa: E731
    if kname == "gcn_aggregate_bwd":
        x, adj, w, g, loop, add_loop, need_x, need_adj = args
        B, N, Fi = x.shape
        Fo = w.shape[1]
        dx, dadj = new(B, N, Fi) if need_x else None, new(B, N, N) if need_adj else None
        part, out_w = new(B, Fi * Fo + Fo), new(Fi * Fo + Fo)
        call = (x.data_ptr(), adj.data_ptr(), w.data_ptr(), g.data_ptr(), ptr(dx), ptr(dadj),
                part.data_ptr(), out_w.data_ptr(), B, N, Fi, Fo, int(add_loop), float(loop))
    else:
        x, adj, wq, bq, wk, bk, wv, bv, gv, ga, H, O, loop, add_loop, need_x, need_adj = args
        B, N, Fi = x.shape
        C, _, A = wq.shape
        size = 2 * C * Fi * A + C * Fi * O + 2 * C * A + C * O
        out_w, part_w = new(size), new(B, size)
        dx, part_x = (new(B, N, Fi), new(B, C, N, Fi)) if need_x else (None, None)
        dadj = torch.empty_like(adj) if need_adj else None
        call = (x.data_ptr(), adj.data_ptr(), wq.data_ptr(), ptr(bq), wk.data_ptr(), ptr(bk),
                wv.data_ptr(), ptr(bv), gv.data_ptr(), ga.data_ptr(), ptr(dx), ptr(dadj),
                ptr(part_x), part_w.data_ptr(), out_w.data_ptr(), B, C, N, Fi, A, O, H, A // H,
                *adj.stride(), *ga.stride(), *(dadj.stride() if need_adj else (0,) * 4),
                math.sqrt(O), int(add_loop), float(loop))

    def run():
        if fn(*call, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"parent {kname}: launch failed")
    return run


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="an unpacked tree of an earlier commit")
    ap.add_argument("--parent-only", action="store_true",
                    help="time only the parent's kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_stage_times: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_name_power()
    print(card, flush=True)
    new = not args.parent_only
    libs = build_variants(args.parent, new)
    wrappers = {"gcn_aggregate_bwd": gcn_aggregate_bwd, "gmh_attention_bwd": gmh_attention_bwd}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(run, **kv):
        run()
        torch.cuda.synchronize()
        kv["us"] = round(1e3 * cs.call_ms(run)[0], 3)
        rows.append(kv)
        print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)

    def new_run(kname, variant, args):
        lib = build.bind(kname, libs[("new", kname, variant)])

        def run():
            build._LIBS[kname] = lib  # the variant in place of the kernel's library
            wrappers[kname](*args)
        return run

    for kname, cases, mk in (("gcn_aggregate_bwd", GCN_CASES, cs.gcn_bwd_inputs),
                             ("gmh_attention_bwd", GMH_CASES, cs.gmh_bwd_inputs)):
        for case in cases:
            args_ = mk(case, gen, dev)
            shape = dict(kernel=kname, case=case[0])
            turns = ((["parent"] if args.parent else []) + (["new", "new"] if new else [])
                     + (["parent"] if args.parent else []))
            for tree in turns:  # the whole kernels, in turns
                run = (parent_launcher(libs[("parent", kname, "base")], kname, args_)
                       if tree == "parent" else new_run(kname, "base", args_))
                record(run, **shape, tree=tree, variant="base")
            for (tree, k, variant), lib in libs.items():
                if k != kname or variant == "base":
                    continue
                run = (parent_launcher(lib, kname, args_) if tree == "parent"
                       else new_run(kname, variant, args_))
                record(run, **shape, tree=tree, variant=variant)
    build._LIBS.clear()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
