"""Where the time of the two normalising kernels goes, on the card.

Times ``channel_agg`` and ``gcn_aggregate`` at the community_small layer
shapes (B = 128, N = 20: ``gcn_aggregate`` F_in 11 and 32 to F_out 32;
``channel_agg`` C = 2 on F = 11 with a contiguous adjacency, C = 8 on
F = 32 with the channels-last adjacency a later layer passes, and
contiguous), and at grid's (B = 8, N = 361: ``channel_agg`` C = 2 on F = 5,
contiguous, and C = 8 on F = 32, channels-last; there the kernel reads the
degrees of a ``gcn_degrees`` launch, made once outside the timed loop and
timed on its own, and the pair the wrapper launches, the degrees then the
kernel, is timed as ``with_gcn_degrees``; ``gcn_aggregate`` F_in 5 and 32
to F_out 32 as the wrapper launches it, a ``gcn_degrees`` launch and then
the row tiles, and the kernel alone on degrees made before; the parent's
pair, its degrees and its 32-row tiles, beside them):

* each kernel whole, and with stages removed: a build with
  ``-DGCN_ABLATE=<mask>`` (``csrc/gcn_common.cuh``) removes the loads (a
  zero fill in their place), the degrees (d = 1, not applied), the product
  A (d X), the projection (gcn_aggregate's (.) W) or the store;
  ``loads_only`` removes all but the loads, ``empty`` everything but the
  launch and the barriers;
* with ``--parent DIR``, a tree of an earlier commit unpacked by ``git
  archive <commit> ccsd_tpu_torch | tar -x -C DIR`` whose sources have the
  same ablation mask and C entry points (the commit of the tensor-core
  aggregation tile or a later one): its three kernels built the same way
  and called through ctypes, the whole kernels of both trees timed in
  turns (parent, this, this, parent), then the parent's stages; at grid's
  shapes whether the ``gcn_aggregate`` output equals the parent's bit for
  bit; ``--parent-only`` times the parent's kernels and stages alone;
* at grid's shapes, this tree's ``channel_agg`` at every channel group G.

Each variant is built with the flags of ``ccsd_tpu_torch/kernels/build.py``
into ``build/stage_times/``, all in parallel, and timed as ``chip_smoke.py``
times the kernels (CUDA-graph replay of 200 launches, CUDA events).  Run
from the repo root on a machine with an NVIDIA H100:

    python3 scripts/gcn_stage_times.py [--parent DIR [--parent-only]]

Prints the card's name and power limit, the ptxas report of each base
build, one line per measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccsd_tpu_torch.kernels import build  # noqa: E402
from ccsd_tpu_torch.kernels.gcn import agg_group, gcn_rows, rows_per_block  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "stage_times")
# the Stage masks of csrc/gcn_common.cuh
LOADS, DEGREES, PRODUCT, PROJECTION, STORE = 1, 2, 4, 8, 16
VARIANTS = {
    "channel_agg": {"base": 0, "no_loads": LOADS, "no_degrees": DEGREES,
                    "no_product": PRODUCT, "no_store": STORE,
                    "loads_only": DEGREES | PRODUCT | STORE,
                    "empty": LOADS | DEGREES | PRODUCT | STORE},
    "gcn_aggregate": {"base": 0, "no_loads": LOADS, "no_degrees": DEGREES,
                      "no_product": PRODUCT, "no_projection": PROJECTION, "no_store": STORE,
                      "loads_only": DEGREES | PRODUCT | PROJECTION | STORE,
                      "empty": LOADS | DEGREES | PRODUCT | PROJECTION | STORE},
    "gcn_degrees": {"base": 0},
}
# channel_agg: (B, C, N, F, adjacency layout)
AGG_CASES = [(128, 2, 20, 11, "contiguous"), (128, 8, 20, 32, "channels-last"),
             (128, 8, 20, 32, "contiguous"), (8, 2, 361, 5, "contiguous"),
             (8, 8, 361, 32, "channels-last")]
# gcn_aggregate: (B, N, F_in, F_out)
GCN_CASES = [(128, 20, 11, 32), (128, 20, 32, 32), (8, 361, 5, 32), (8, 361, 32, 32)]


def build_variants(parent_dir, parent_only=False):
    """{(tree, kernel, variant): launcher}, all built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    trees = {} if parent_only else {"new": build.CSRC_DIR}
    if parent_dir:
        trees["parent"] = os.path.join(parent_dir, "ccsd_tpu_torch", "csrc")
    jobs = {(tree, kname, variant): (os.path.join(src, f"{kname}.cu"),
                                     os.path.join(OUT_DIR, f"lib{kname}_{tree}_{variant}.so"),
                                     [f"-DGCN_ABLATE={mask}"])
            for tree, src in trees.items()
            for kname, variants in VARIANTS.items() for variant, mask in variants.items()}
    logs = build.nvcc_parallel(jobs)
    fns = {}
    for (tree, kname, variant), (_, lib, _) in jobs.items():
        if variant == "base":
            print(f"ptxas {tree} {kname}: " + " | ".join(
                ln.split("info    : ")[-1].strip()
                for ln in logs[(tree, kname, variant)].splitlines() if "Used" in ln), flush=True)
        fns[(tree, kname, variant)] = getattr(build.bind(kname, lib),
                                              next(iter(build.SIGNATURES[kname])))
    return fns


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="an unpacked tree of an earlier commit")
    ap.add_argument("--parent-only", action="store_true",
                    help="with --parent: time the parent's kernels and stages alone")
    args = ap.parse_args(argv)
    if args.parent_only and not args.parent:
        ap.error("--parent-only needs --parent DIR")
    if not torch.cuda.is_available():
        print("gcn_stage_times: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_name_power()
    print(card, flush=True)
    fns = build_variants(args.parent, args.parent_only)
    if args.parent_only:
        trees, turns = ["parent"], ["parent"]
    else:
        trees = ["new", "parent"] if args.parent else ["new"]
        turns = ["parent", "new", "new", "parent"] if args.parent else ["new"]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, checks = [], []

    def stream():  # the current stream, which a graph capture changes
        return torch.cuda.current_stream().cuda_stream

    def record(run, **kv):
        run()
        torch.cuda.synchronize()
        kv["us"] = round(1e3 * cs.call_ms(run)[0], 3)
        rows.append(kv)
        print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)

    def checked(*launches):  # launches: (fn, args) run back to back
        def run():
            for fn, a in launches:
                if fn(*a, stream()):
                    raise RuntimeError("launch failed")
        return run

    def rerun(launched):  # the route's launches again: their output
        ls, out = launched
        checked(*ls)()
        torch.cuda.synchronize()
        return out

    def plain(x, adj, w, b):
        from ccsd_tpu_torch.kernels.gcn import gcn_aggregate_plain
        return gcn_aggregate_plain(x, adj, w, b)

    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    for B, C, N, F, layout in AGG_CASES:
        adj, x = cs.agg_inputs(("stage", B, C, N, F), gen, dev)
        if layout == "channels-last":
            adj = cs.channels_last(adj)
        out = torch.empty(B, C, N, F, device=dev)
        r = rows_per_block(N)
        deg = torch.empty(B, C, N, device=dev) if r < N else None
        shape = dict(kernel="channel_agg", B=B, C=C, N=N, F=F, adj=layout)

        def agg(tree, variant, G=agg_group(C)):
            a = [adj.data_ptr(), x.data_ptr(), ptr(deg), out.data_ptr(), B, C, N, F,
                 *adj.stride(), r, G, 0]
            return fns[(tree, "channel_agg", variant)], a

        def degrees(tree):
            return (fns[(tree, "gcn_degrees", "base")],
                    [adj.data_ptr(), deg.data_ptr(), B, C, N, *adj.stride(), 1, 1.0])

        if deg is not None:
            checked(degrees(trees[0]))()
        for tree in turns:
            record(checked(agg(tree, "base")), **shape, tree=tree, variant="base")
        if deg is not None:
            for tree in turns:
                record(checked(degrees(tree)), **shape, tree=tree, variant="gcn_degrees")
            for tree in turns:
                record(checked(degrees(tree), agg(tree, "base")), **shape, tree=tree,
                       variant="with_gcn_degrees")
        for tree in trees:
            for variant in VARIANTS["channel_agg"]:
                if variant != "base":
                    record(checked(agg(tree, variant)), **shape, tree=tree, variant=variant)
        if deg is not None and "new" in trees:
            for G in (1, 2, 4, 8):
                if G <= C and G != agg_group(C):
                    record(checked(agg("new", "base", G)), **shape, tree="new", G=G,
                           variant="base", sweep="G")

    for B, N, Fi, Fo in GCN_CASES:
        x, adj, w, b, _ = cs.gcn_inputs(("stage", B, N, Fi, Fo, 1.0), gen, dev)
        shape = dict(kernel="gcn_aggregate", B=B, N=N, F_in=Fi, F_out=Fo)
        tiled = N > 64
        # rows a block: this tree's plan, the parent's 32-row tiles
        r = {"new": gcn_rows(N), "parent": rows_per_block(N)}
        deg = {t: torch.empty(B, 1, N, device=dev) for t in trees} if tiled else {}
        outs = {}

        def degrees(tree):
            return (fns[(tree, "gcn_degrees", "base")],
                    [adj.data_ptr(), deg[tree].data_ptr(), B, 1, N, N * N, N * N, N, 1, 1,
                     1.0])

        def gcn(tree, variant, route):
            # route: "whole" (N <= 64) or "degrees" (the degrees of a
            # gcn_degrees launch, then the row tiles)
            out = torch.empty(B, N, Fo, device=dev)
            d = deg[tree].data_ptr() if route == "degrees" else 0
            return (fns[(tree, "gcn_aggregate", variant)],
                    [x.data_ptr(), adj.data_ptr(), d, w.data_ptr(), b.data_ptr(),
                     out.data_ptr(), B, N, Fi, Fo, r[tree], 1, 1.0]), out

        def launches(tree, route, variant="base"):
            """What the wrapper launches for the route, and the output."""
            call, out = gcn(tree, variant, route)
            return ([degrees(tree), call] if route == "degrees" else [call]), out

        route = "degrees" if tiled else "whole"
        for tree in turns:
            ls, outs[(tree, route)] = launches(tree, route)
            record(checked(*ls), **shape, tree=tree, route=route, rows=r[tree], variant="base")
        if tiled:
            for tree in trees:  # the kernel alone, on degrees made before
                checked(degrees(tree))()
                record(checked(gcn(tree, "base", "degrees")[0]), **shape, tree=tree,
                       route="degrees", rows=r[tree], variant="kernel_alone")
            torch.cuda.synchronize()
            ref = outs.get(("parent", "degrees"))
            for (tree, rt), out in outs.items():
                row = dict(check=f"gcn_aggregate {B}x{N} {Fi}->{Fo}", tree=tree, route=rt,
                           max_abs_err_vs_plain=(out - plain(x, adj, w, b)).abs().max().item())
                if ref is not None and tree == "new":
                    row["parent_bit_equal"] = bool(torch.equal(out, ref))
                    row["repeat_bit_identical"] = bool(torch.equal(
                        out, rerun(launches(tree, rt))))
                checks.append(row)
                print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        for tree in trees:
            for variant in VARIANTS["gcn_aggregate"]:
                if variant != "base":
                    ls, _ = launches(tree, route, variant)
                    record(checked(*ls), **shape, tree=tree, route=route, rows=r[tree],
                           variant=variant)
    print(json.dumps({"card": card, "rows": rows, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
