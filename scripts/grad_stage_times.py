"""Where the time of the backward kernels goes, on the card.

Two sets of shapes, each asking for the gradients the training path asks
for (``chip_smoke.gcn_bwd_inputs``, ``chip_smoke.gmh_bwd_inputs``):

* community_small's training shapes (B = 80, N = 20): ``gcn_aggregate_bwd``
  on ScoreNetworkX's first layer (F_in 11, dW and dbias only), a later one
  (F_in 32, with dx) and a later one with dadj too (off the path); the
  one-block ``gmh_attention_bwd`` on ScoreNetworkA's first AttentionLayer
  (C = 2, F_in 11, a contiguous adjacency, no dx or dadj) and a later one
  (C = 8, F_in 32, the channels-last adjacency, with dx and dadj);
* grid's attention layers (B = 8, N = 361: the tiled design; C = 2 on F_in
  5 without dx or dadj, C = 8 on F_in 32 with both and the channels-last
  adjacency): the whole ``gmh_attention_bwd`` call and each of the tiled
  design's kernels alone (``gmh_bwd_layout``, ``gmh_score_grad``,
  ``gmh_attention_bwd_tiled``, on the inputs the launches before them
  give).

Each is timed whole and with stages removed: a build with
``-DGRAD_ABLATE=<mask>`` (``csrc/grad_common.cuh``) puts a zero fill of
what a stage writes in its place; ``skeleton`` keeps the loads, the
barriers and the stores.  ``gmh_attention_bwd`` also in other geometries
of its one-block kernel, built from this tree's source with one line
edited (clusters of 4 and of 2 blocks in place of 8; 192 threads a block,
five blocks an SM).

With ``--parent DIR``, a tree of an earlier commit unpacked by ``git
archive <commit> | tar -x -C DIR`` whose tiled attention backward has the
C entry points of 80a8d86 (``gmh_score_grad_run`` taking dL/dA,
``gmh_attention_bwd_tiled_run`` taking the adjacency's four strides): its
``gmh_attention_bwd.cu`` built the same way (its own ``GRAD_ABLATE``
masks), its two tiled kernels called through ctypes after this tree's
``gcn_degrees`` and ``gmh_projection`` (unchanged), at grid's shapes: the
earlier whole call and each earlier kernel, whole and with stages removed;
the earlier and this tree's whole calls and kernels are timed in turns
(parent, this, this, parent).  ``--parent-only`` times only the parent's.

Each variant is built with the flags of ``ccsd_tpu_torch/kernels/build.py``
into ``build/stage_times_grad/``, all in parallel, and timed as
``chip_smoke.py`` times the kernels (CUDA-graph replay, CUDA events: 200
launches at N = 20, 20 at N = 361); this tree's variants run through the
wrappers, with the variant's library bound in place of the kernel's.  Run
from the repo root on a machine with an NVIDIA H100:

    python3 scripts/grad_stage_times.py [--parent DIR [--parent-only]] [--tiled-only]

Prints the card's name and power limit, the ptxas report of each base
build, one line per measurement and, last, a JSON object of them all.
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
from ccsd_tpu_torch.kernels.gcn import (  # noqa: E402
    MAX_CLUSTER, gcn_aggregate_bwd, gcn_degrees, row_tiles, ticket_buffer)
from ccsd_tpu_torch.kernels.gmh_attention import (  # noqa: E402
    gmh_attention_bwd, gmh_attention_bwd_tiled, gmh_bwd_layout, gmh_projection,
    gmh_score_grad)

OUT_DIR = os.path.join(ROOT, "build", "stage_times_grad")
# the Stage masks of csrc/grad_common.cuh
(LOADS, RECOMPUTE, SCORES, GRAD_QK, GRAD_W, GRAD_NX, GRAD_X, GRAD_ADJ, REDUCE, GRAD_Y,
 GRAD_V) = (1 << i for i in range(11))
GMH_STAGES = {"no_recompute": RECOMPUTE, "no_scores": SCORES, "no_grad_qk": GRAD_QK,
              "no_grad_w": GRAD_W, "no_grad_nx": GRAD_NX, "no_grad_x": GRAD_X,
              "no_grad_adj": GRAD_ADJ, "no_reduce": REDUCE}
VARIANTS = {
    "gcn_aggregate_bwd": {"base": 0, "no_loads": LOADS, "no_grad_y": GRAD_Y,
                          "no_grad_x": GRAD_X, "no_grad_w": GRAD_W, "no_grad_adj": GRAD_ADJ,
                          "no_reduce": REDUCE,
                          "skeleton": GRAD_Y | GRAD_X | GRAD_W | GRAD_ADJ | REDUCE},
    "gmh_attention_bwd": {"base": 0, "no_loads": LOADS, **GMH_STAGES, "no_grad_v": GRAD_V,
                          "no_da_pass": GRAD_Y,
                          "skeleton": sum(GMH_STAGES.values()) | GRAD_V},
}
# the earlier tree's gmh_attention_bwd.cu (its masks: its tiled row kernel
# has its V product under GRAD_X)
PARENT_VARIANTS = {"base": 0, "no_loads": LOADS, **GMH_STAGES,
                   "skeleton": sum(GMH_STAGES.values())}
# this tree's one-block gmh_attention_bwd in other geometries, as {variant:
# [(file, line, replacement)]}
_LAUNCH = ("gmh_attention_bwd.cu", "gmh_attention_bwd_kernel<<<grid, kThreads, smem",
           "gmh_attention_bwd_kernel<<<grid, 192, smem")
_BOUNDS = ("gmh_attention_bwd.cu", "__launch_bounds__(kThreads, 4)", "__launch_bounds__(192, 5)")
GEOMETRIES = {
    "cluster4": [("grad_common.cuh", "constexpr int kCluster = 8;", "constexpr int kCluster = 4;")],
    "cluster2": [("grad_common.cuh", "constexpr int kCluster = 8;", "constexpr int kCluster = 2;")],
    "threads192": [_LAUNCH, _BOUNDS],
}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
PARENT_SYMBOLS = {  # the earlier tiled design's C entry points
    "gmh_score_grad_run": [_P] * 3 + [_I] * 6 + [_L] * 4 + [_F, _P],
    "gmh_attention_bwd_tiled_run": [_P] * 14 + [_I] * 7 + [_L] * 8 + [_I, _F, _P],
}

# (name, B, N, F_in, F_out, loop, need_x, need_adj): chip_smoke.gcn_bwd_inputs
GCN_CASES = [("x.layers.0", 80, 20, 11, 32, 1.0, False, False),
             ("x.layers.1", 80, 20, 32, 32, 1.0, True, False),
             ("x.layers.1 with dadj", 80, 20, 32, 32, 1.0, True, True)]
# (name, B, C, N, F_in, attn, F_out, H, need_x, need_adj): chip_smoke.gmh_bwd_inputs
# (layer 0: a contiguous adjacency; later layers: channels-last)
GMH_CASES = [("adj.layers.0", 80, 2, 20, 11, 32, 32, 4, False, False),
             ("adj.layers.1", 80, 8, 20, 32, 32, 32, 4, True, True)]
TILED_CASES = [("grid.layers.0", 8, 2, 361, 5, 32, 32, 4, False, False),
               ("grid.layers.1", 8, 8, 361, 32, 32, 32, 4, True, True)]


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
        src = os.path.join(parent_dir, "ccsd_tpu_torch", "csrc", "gmh_attention_bwd.cu")
        for variant, mask in PARENT_VARIANTS.items():
            jobs[("parent", "gmh_attention_bwd", variant)] = (
                src, os.path.join(OUT_DIR, f"libgmh_attention_bwd_parent_{variant}.so"),
                [f"-DGRAD_ABLATE={mask}"])
    logs = build.nvcc_parallel(jobs)
    for (tree, kname, variant) in jobs:
        if variant == "base":
            print(f"ptxas {tree} {kname}: " + " | ".join(
                ln.split("info    : ")[-1].strip()
                for ln in logs[(tree, kname, variant)].splitlines()
                if "Used" in ln or "Compiling entry" in ln), flush=True)
    return {key: lib for key, (_, lib, _) in jobs.items()}


class Parent:
    """The earlier tiled design through its C entry points: ``score_grad``
    (qk, dL/dA in its strides) and ``rows`` (its row-tile kernel, the
    adjacency in its strides, scratch allocated as its wrapper did)."""

    def __init__(self, lib_path):
        lib = ctypes.CDLL(lib_path)
        self.fns = {}
        for sym, argtypes in PARENT_SYMBOLS.items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.fns[sym] = fn

    def _call(self, sym, *args):
        if self.fns[sym](*args, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError(f"parent {sym}: launch failed")

    def score_grad(self, qk, ga, H, O):
        B, C, N, A2 = qk.shape
        gqk = torch.empty_like(qk)
        self._call("gmh_score_grad_run", qk.data_ptr(), ga.data_ptr(), gqk.data_ptr(), B, C, N,
                   A2 // 2, H, A2 // 2 // H, *ga.stride(), math.sqrt(O))
        return gqk

    def rows(self, x, adj, deg, wq, wk, wv, gqk, gv, loop, add_loop, need_x, need_adj):
        B, N, Fi = x.shape
        C, _, A = wq.shape
        O = wv.shape[-1]
        nt = len(row_tiles(N))
        clusters = -(-B * nt // MAX_CLUSTER)
        T = Fi * (2 * A + O) + 2 * A + O
        new = lambda *s: torch.empty(*s, device=x.device)  # noqa: E731
        out_w, part_w = new(C * T), new(clusters, C * T)
        dx, part_x = (new(B, N, Fi), new(B, C, N, Fi)) if need_x else (None, None)
        dadj = torch.empty_like(adj) if need_adj else None
        tickets = ticket_buffer(x.device, MAX_CLUSTER * C + B * nt)
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        self._call("gmh_attention_bwd_tiled_run", x.data_ptr(), adj.data_ptr(), deg.data_ptr(),
                   wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), gqk.data_ptr(), gv.data_ptr(),
                   ptr(dx), ptr(dadj), ptr(part_x), part_w.data_ptr(), out_w.data_ptr(),
                   tickets.data_ptr(), B, C, N, Fi, A, O, clusters, *adj.stride(),
                   *(dadj.stride() if need_adj else (0,) * 4), int(add_loop), float(loop))
        return out_w

    def whole(self, args):
        x, adj, wq, bq, wk, bk, wv, bv, gv, ga, H, O, loop, add_loop, need_x, need_adj = args
        deg = gcn_degrees(adj, add_loop, loop)
        qk, _ = gmh_projection(x, adj, deg, wq, bq, wk, bk, wv, bv, loop, add_loop)
        return self.rows(x, adj, deg, wq, wk, wv, self.score_grad(qk, ga, H, O), gv.contiguous(),
                         loop, add_loop, need_x, need_adj)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="an unpacked tree of an earlier commit")
    ap.add_argument("--parent-only", action="store_true",
                    help="time only the parent's kernels")
    ap.add_argument("--tiled-only", action="store_true",
                    help="only grid's shapes (the tiled design)")
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

    def record(run, iters, **kv):
        run()
        torch.cuda.synchronize()
        kv["us"] = round(1e3 * cs.call_ms(run, iters)[0], 3)
        rows.append(kv)
        print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)

    def use(variant):  # this tree's variant in place of the kernel's library
        build._LIBS["gmh_attention_bwd"] = build.bind("gmh_attention_bwd",
                                                      libs[("new", "gmh_attention_bwd", variant)])

    # N = 20: this tree's one-block kernels, whole and by stages
    if new and not args.tiled_only:
        for kname, cases, mk in (("gcn_aggregate_bwd", GCN_CASES, cs.gcn_bwd_inputs),
                                 ("gmh_attention_bwd", GMH_CASES, cs.gmh_bwd_inputs)):
            for case in cases:
                args_ = mk(case, gen, dev)
                for (tree, k, variant), lib in libs.items():
                    if tree != "new" or k != kname:
                        continue

                    def run(lib=lib, kname=kname, args_=args_):
                        build._LIBS[kname] = build.bind(kname, lib)
                        wrappers[kname](*args_)
                    record(run, cs.TIMING_ITERS, kernel=kname, case=case[0], tree=tree,
                           variant=variant)
        build._LIBS.clear()

    # N = 361: the tiled design, this tree's and the parent's
    parents = {v: Parent(libs[("parent", "gmh_attention_bwd", v)])
               for v in PARENT_VARIANTS} if args.parent else {}
    iters = cs.GRID_TIMING_ITERS
    for case in TILED_CASES:
        a = cs.gmh_bwd_inputs(case, gen, dev)
        x, adj, wq, bq, wk, bk, wv, bv, gv, ga, H, O, loop, add_loop, need_x, need_adj = a
        deg = gcn_degrees(adj, add_loop, loop)
        qk, _ = gmh_projection(x, adj, deg, wq, bq, wk, bk, wv, bv, loop, add_loop)
        ac, gm = gmh_bwd_layout(adj, ga)
        gqk = gmh_score_grad(qk, gm, H, O)
        mine = {
            "whole": lambda: gmh_attention_bwd(*a),
            "gmh_bwd_layout": lambda: gmh_bwd_layout(adj, ga),
            "gmh_score_grad": lambda: gmh_score_grad(qk, gm, H, O),
            "gmh_attention_bwd_tiled": lambda: gmh_attention_bwd_tiled(
                x, adj, wq, bq, wk, bk, wv, bv, gqk, gv, deg, ac, loop, add_loop, need_x,
                need_adj),
        }

        def theirs(p):
            gqk_p = p.score_grad(qk, ga, H, O)
            return {"whole": lambda: p.whole(a),
                    "gmh_score_grad": lambda: p.score_grad(qk, ga, H, O),
                    "gmh_attention_bwd_tiled": lambda: p.rows(x, adj, deg, wq, wk, wv, gqk_p,
                                                              gv, loop, add_loop, need_x,
                                                              need_adj)}

        shape = dict(case=case[0])
        for what in mine:  # base against base, in turns
            turns = ((["parent"] if parents else []) + (["new", "new"] if new else [])
                     + (["parent"] if parents else []))
            for tree in turns:
                if tree == "parent":
                    if what == "gmh_bwd_layout":
                        continue
                    record(theirs(parents["base"])[what], iters, kernel=what, **shape,
                           tree=tree, variant="base")
                else:
                    use("base")
                    record(mine[what], iters, kernel=what, **shape, tree=tree, variant="base")
        if new:
            for variant in VARIANTS["gmh_attention_bwd"]:
                if variant == "base":
                    continue
                use(variant)
                for what, run in mine.items():
                    record(run, iters, kernel=what, **shape, tree="new", variant=variant)
        for variant, p in parents.items():
            if variant == "base":
                continue
            for what, run in theirs(p).items():
                record(run, iters, kernel=what, **shape, tree="parent", variant=variant)
        build._LIBS.clear()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
