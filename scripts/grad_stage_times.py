"""Where the time of the backward kernels goes, on the card.

Three sets of shapes, each asking for the gradients the training path asks
for (``chip_smoke.gcn_bwd_inputs``, ``chip_smoke.gmh_bwd_inputs``):

* community_small's training shapes (B = 80, N = 20): ``gcn_aggregate_bwd``
  on ScoreNetworkX's first layer (F_in 11, dW and dbias only), a later one
  (F_in 32, with dx) and a later one with dadj too (off the path); the
  one-block ``gmh_attention_bwd`` on ScoreNetworkA's first AttentionLayer
  (C = 2, F_in 11, a contiguous adjacency, no dx or dadj) and a later one
  (C = 8, F_in 32, the channels-last adjacency, with dx and dadj);
* grid's ScoreNetworkX layers (B = 8, N = 361: the tiled
  ``gcn_aggregate_bwd``; F_in 5 without dx, F_in 32 with dx, F_out 32):
  the whole call as a direct caller makes it (a ``gcn_degrees`` launch,
  then the kernel: ``whole``) and the kernel alone on the degrees of the
  forward (``kernel``: the one launch a training step makes);
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
archive <commit> | tar -x -C DIR`` whose tiled ``gcn_aggregate_bwd`` has
the C entry point of 9375191 (``gcn_aggregate_bwd_tiled_run``: one block a
32-row tile, clusters of eight tiles, the degrees an argument): its
``gcn_aggregate_bwd.cu`` built the same way (its own ``GRAD_ABLATE``
masks) and called through ctypes after this tree's ``gcn_degrees``
(unchanged), at grid's ScoreNetworkX shapes: the earlier whole call and
kernel, whole and with stages removed; the earlier and this tree's whole
calls and kernels are timed in turns (parent, this, this, parent), and
this tree's dx, dW and dbias are compared with the parent's bit for bit.
``--parent-only`` times only the parent's.

Each variant is built with the flags of ``ccsd_tpu_torch/kernels/build.py``
into ``build/stage_times_grad/``, all in parallel, and timed as
``chip_smoke.py`` times the kernels (CUDA-graph replay, CUDA events: 200
launches, 20 for the tiled attention); this tree's variants run through
the wrappers, with the variant's library bound in place of the kernel's.
Run from the repo root on a machine with an NVIDIA H100:

    python3 scripts/grad_stage_times.py [--parent DIR [--parent-only]] [--tiled-only]
        [--kernel gcn_aggregate_bwd|gmh_attention_bwd]

Prints the card's name and power limit, the ptxas report of each base
build, one line per measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccsd_tpu_torch.kernels import build, gcn  # noqa: E402
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
GCN_STAGES = {"base": 0, "no_loads": LOADS, "no_grad_y": GRAD_Y, "no_grad_x": GRAD_X,
              "no_grad_w": GRAD_W, "no_grad_adj": GRAD_ADJ, "no_reduce": REDUCE,
              "skeleton": GRAD_Y | GRAD_X | GRAD_W | GRAD_ADJ | REDUCE}
VARIANTS = {
    # this tree's tiled kernel also: no_fold, its sum of V over the cluster;
    # empty, every stage and the loads removed (the launch, barriers, stores)
    "gcn_aggregate_bwd": {**GCN_STAGES, "no_fold": GRAD_V,
                          "empty": sum(GCN_STAGES.values()) | LOADS | GRAD_V},
    "gmh_attention_bwd": {"base": 0, "no_loads": LOADS, **GMH_STAGES, "no_grad_v": GRAD_V,
                          "no_da_pass": GRAD_Y,
                          "skeleton": sum(GMH_STAGES.values()) | GRAD_V},
}
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
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the earlier tiled gcn_aggregate_bwd's C entry point (9375191)
PARENT_SYMBOL = ("gcn_aggregate_bwd_tiled_run", [_P] * 10 + [_I] * 6 + [_F, _P])

# (name, B, N, F_in, F_out, loop, need_x, need_adj): chip_smoke.gcn_bwd_inputs
GCN_CASES = [("x.layers.0", 80, 20, 11, 32, 1.0, False, False),
             ("x.layers.1", 80, 20, 32, 32, 1.0, True, False),
             ("x.layers.1 with dadj", 80, 20, 32, 32, 1.0, True, True)]
GCN_TILED_CASES = [("grid.x.layers.0", 8, 361, 5, 32, 1.0, False, False),
                   ("grid.x.layers.1", 8, 361, 32, 32, 1.0, True, False)]
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


def build_variants(parent_dir, new, kernels):
    """{(tree, kernel, variant): library path} of the named kernels, all
    built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {}
    if new:
        jobs = {("new", kname, variant): (os.path.join(build.CSRC_DIR, f"{kname}.cu"),
                                          os.path.join(OUT_DIR, f"lib{kname}_new_{variant}.so"),
                                          [f"-DGRAD_ABLATE={mask}"])
                for kname in kernels for variant, mask in VARIANTS[kname].items()}
        for variant, edits in GEOMETRIES.items() if "gmh_attention_bwd" in kernels else ():
            src = edited_copy(build.CSRC_DIR, "gmh_attention_bwd",
                              os.path.join(OUT_DIR, "geometry_src", variant), edits)
            jobs[("new", "gmh_attention_bwd", variant)] = (
                src, os.path.join(OUT_DIR, f"libgmh_attention_bwd_new_{variant}.so"), [])
    if parent_dir:
        src = os.path.join(parent_dir, "ccsd_tpu_torch", "csrc", "gcn_aggregate_bwd.cu")
        for variant, mask in GCN_STAGES.items():
            jobs[("parent", "gcn_aggregate_bwd", variant)] = (
                src, os.path.join(OUT_DIR, f"libgcn_aggregate_bwd_parent_{variant}.so"),
                [f"-DGRAD_ABLATE={mask}"])
    logs = build.nvcc_parallel(jobs)
    for (tree, kname, variant) in jobs:
        if variant == "base":
            print(f"ptxas {tree} {kname}: " + " | ".join(
                ln.split("info    : ")[-1].strip()
                for ln in logs[(tree, kname, variant)].splitlines()
                if "Used" in ln or "Compiling entry" in ln), flush=True)
    return {key: lib for key, (_, lib, _) in jobs.items()}


class ParentGcn:
    """The earlier tiled ``gcn_aggregate_bwd`` through its C entry point:
    ``kernel`` on given degrees, scratch allocated as its wrapper did (a
    weight partial for each cluster of eight row tiles); ``whole`` after
    this tree's ``gcn_degrees``, as its wrapper launched the pair."""

    def __init__(self, lib_path):
        self.fn = getattr(ctypes.CDLL(lib_path), PARENT_SYMBOL[0])
        self.fn.argtypes, self.fn.restype = PARENT_SYMBOL[1], ctypes.c_int

    def kernel(self, x, adj, w, g, loop, add_loop, need_x, need_adj, deg):
        B, N, Fi = x.shape
        Fo = w.shape[1]
        clusters = -(-B * len(row_tiles(N)) // MAX_CLUSTER)
        new = lambda *s: torch.empty(*s, device=x.device)  # noqa: E731
        dx = new(B, N, Fi) if need_x else None
        dadj = new(B, N, N) if need_adj else None
        out_w, part = new(Fi * Fo + Fo), new(clusters, Fi * Fo + Fo)
        tickets = ticket_buffer(x.device, MAX_CLUSTER)
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        if self.fn(x.data_ptr(), adj.data_ptr(), deg.data_ptr(), w.data_ptr(), g.data_ptr(),
                   ptr(dx), ptr(dadj), part.data_ptr(), out_w.data_ptr(), tickets.data_ptr(),
                   B, N, Fi, Fo, clusters, int(add_loop), float(loop),
                   torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("parent gcn_aggregate_bwd_tiled_run: launch failed")
        return dx, dadj, out_w[:Fi * Fo].view(Fi, Fo), out_w[Fi * Fo:]

    def whole(self, x, adj, w, g, loop, add_loop, need_x, need_adj):
        deg = gcn_degrees(adj[:, None], add_loop, loop)
        return self.kernel(x, adj, w, g, loop, add_loop, need_x, need_adj, deg)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="an unpacked tree of an earlier commit")
    ap.add_argument("--parent-only", action="store_true",
                    help="time only the parent's kernels")
    ap.add_argument("--tiled-only", action="store_true",
                    help="only grid's shapes (the tiled designs)")
    ap.add_argument("--kernel", choices=list(VARIANTS), default=None,
                    help="only this backward kernel")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_stage_times: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_name_power()
    print(card, flush=True)
    new = not args.parent_only
    kernels = [args.kernel] if args.kernel else list(VARIANTS)
    libs = build_variants(args.parent if "gcn_aggregate_bwd" in kernels else None, new, kernels)
    wrappers = {"gcn_aggregate_bwd": gcn_aggregate_bwd, "gmh_attention_bwd": gmh_attention_bwd}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(run, iters, **kv):
        run()
        torch.cuda.synchronize()
        kv["us"] = round(1e3 * cs.call_ms(run, iters)[0], 3)
        rows.append(kv)
        print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)

    def use(kname, variant):  # this tree's variant in place of the kernel's library
        build._LIBS[kname] = build.bind(kname, libs[("new", kname, variant)])

    # N = 20: this tree's one-block kernels, whole and by stages
    if new and not args.tiled_only:
        for kname, cases, mk in (("gcn_aggregate_bwd", GCN_CASES, cs.gcn_bwd_inputs),
                                 ("gmh_attention_bwd", GMH_CASES, cs.gmh_bwd_inputs)):
            for case in cases if kname in kernels else []:
                args_ = mk(case, gen, dev)
                for variant in VARIANTS[kname]:
                    def run(kname=kname, args_=args_):
                        wrappers[kname](*args_)
                    use(kname, variant)
                    record(run, cs.TIMING_ITERS, kernel=kname, case=case[0], tree="new",
                           variant=variant)
        build._LIBS.clear()

    # N = 361, ScoreNetworkX: the tiled gcn_aggregate_bwd, this tree's and the parent's
    parents = {v: ParentGcn(libs[("parent", "gcn_aggregate_bwd", v)])
               for v in GCN_STAGES} if ("parent", "gcn_aggregate_bwd", "base") in libs else {}
    for case in GCN_TILED_CASES if "gcn_aggregate_bwd" in kernels else []:
        a = cs.gcn_bwd_inputs(case, gen, dev)
        deg = gcn_degrees(a[1][:, None], a[5], a[4])
        mine = {"whole": lambda: gcn_aggregate_bwd(*a),
                "kernel": lambda: gcn_aggregate_bwd(*a, deg=deg)}
        theirs = lambda p: {"whole": lambda: p.whole(*a),  # noqa: E731
                            "kernel": lambda: p.kernel(*a, deg)}
        shape = dict(kernel="gcn_aggregate_bwd", case=case[0])
        if new:
            use("gcn_aggregate_bwd", "base")
        for what in mine:  # base against base, in turns
            turns = ((["parent"] if parents else []) + (["new", "new"] if new else [])
                     + (["parent"] if parents else []))
            for tree in turns:
                run = theirs(parents["base"])[what] if tree == "parent" else mine[what]
                record(run, cs.TIMING_ITERS, **shape, call=what, tree=tree, variant="base")
        if new and parents:
            got, want = mine["kernel"](), theirs(parents["base"])["kernel"]()
            torch.cuda.synchronize()
            same = {out: (g is None and w is None) or (g is not None and w is not None
                                                       and torch.equal(g, w))
                    for out, g, w in zip(("dx", "dadj", "dweight", "dbias"), got, want)}
            rows.append({**shape, "bit_equal_to_parent": same})
            print(f"check {case[0]}: bit equal to the parent: {json.dumps(same)}", flush=True)
        if new:
            for variant in VARIANTS["gcn_aggregate_bwd"]:
                if variant == "base":
                    continue
                use("gcn_aggregate_bwd", variant)
                for what, run in mine.items():
                    record(run, cs.TIMING_ITERS, **shape, call=what, tree="new",
                           variant=variant)
            # the base and empty kernels at row tiles of the plan's rows, of
            # 11 and 12 (two blocks an SM at grid) and of 32, each with every
            # chunk in one pass, in two and in three (the base outputs' dX
            # bit-equal to the plan's)
            use("gcn_aggregate_bwd", "base")
            want, geometry = mine["kernel"](), gcn.gcn_bwd_geometry
            nk = len(row_tiles(case[2]))
            for tile in sorted({geometry(*case[2:4], 32, False)[0], 11, 12, 32}):
                for pc in (nk, -(-nk // 2), -(-nk // 3)):
                    gcn.gcn_bwd_geometry = lambda *k, tile=tile, pc=pc: (tile, pc, 0)  # noqa: E731
                    for variant in ("base", "empty"):
                        use("gcn_aggregate_bwd", variant)
                        got = mine["kernel"]()
                        same = variant != "base" or got[0] is None or torch.equal(got[0], want[0])
                        record(mine["kernel"], cs.TIMING_ITERS, **shape, call="kernel",
                               tree="new", variant=variant, rows=tile, chunks_a_pass=pc,
                               dx_bit_equal=same)
            gcn.gcn_bwd_geometry = geometry
        for variant, p in parents.items():
            if variant == "base":
                continue
            for what, run in theirs(p).items():
                record(run, cs.TIMING_ITERS, **shape, call=what, tree="parent",
                       variant=variant)
        build._LIBS.clear()

    # N = 361, ScoreNetworkA: this tree's tiled attention backward
    iters = cs.GRID_TIMING_ITERS
    for case in TILED_CASES if new and "gmh_attention_bwd" in kernels else []:
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
        for variant in VARIANTS["gmh_attention_bwd"]:
            use("gmh_attention_bwd", variant)
            for what, run in mine.items():
                record(run, iters, kernel=what, case=case[0], tree="new", variant=variant)
        build._LIBS.clear()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
