"""Where the time of the two attention kernels goes, on the card.

Times ``gmh_attention`` and ``gmh_scores`` (both product types) at the
community_small layer shapes (B = 128, N = 20, attn = F_out = 32, 4 heads;
C = 2 on F_in = 11 and C = 8 on F_in = 32), and the tiled design's
``gmh_projection`` at grid's attention layers (B = 8, N = 361, attn = F_out
= 32: C = 2 on F_in = 5 with a contiguous adjacency, C = 8 on F_in = 32
with the channels-last adjacency a later layer passes; the degrees formed
once outside the timed loop):

* each kernel whole, and with stages removed: a build with
  ``-DGMH_ABLATE=<mask>`` (``csrc/gmh_common.cuh``) puts a zero fill of the
  buffer a stage writes in its place, so that the stages after it see
  finite values.  The stages: the product norm X, the projection
  (norm X) W, the head sums, the symmetrised store; ``skeleton`` removes
  all four and leaves the loads, the normalisation and the barriers.
  ``gmh_attention`` runs at C = 8 with the adjacency in both layouts the
  unfused path gives it: contiguous (the first layer's) and channels-last
  (a later layer's);
* ``gmh_scores`` at every channel-group size G (channels per block), to
  show what the wrapper's choice of G gives;
* ``gmh_projection`` whole and without its aggregation (``no_norm_x``), its
  product with the weights (``no_projection``), both (``skeleton``: the
  loads, the degrees, the barriers and the stores) or its copies of the
  adjacency and X (``no_loads``), at the wrapper's G, and whole at every G;
* the tile-pair score stage at grid's attention layers (B = 8, N = 361,
  attn = F_out = 32, 4 heads; C = 2 and 8): ``gmh_scores``' launch in bf16
  and f32 (Q and K strided column blocks of one projection, as the fused
  layer hands them over) and ``gmh_attention``'s in f32 (Q | K of the
  projection's scratch), whole, without the head sums (``no_head_sums``:
  the products and the tanh), the stores (``no_store``) or the copies of
  Q and K (``no_loads``), at the wrapper's G, and whole at every G; each
  output checked (f32 within 1e-5 of the plain version, bf16 within
  ``bf16_scores_tol``, the map exactly symmetric);
* with ``--parent DIR``, a tree of an earlier commit unpacked by ``git
  archive <commit> ccsd_tpu_torch | tar -x -C DIR`` whose
  ``gmh_attention.cu`` and ``gmh_scores.cu`` have the same C entry points:
  its libraries built with the same masks, at the G its wrappers chose
  (32-row tiles, G halved while fewer blocks than SMs), the whole
  ``gmh_attention`` (N = 20), ``gmh_projection`` (grid) and tile-pair
  stage (grid) of both trees timed in turns (parent, this, this, parent),
  then the parent's stages; whether the two trees' f32 maps are equal bit
  for bit.  ``--parent-only`` times the parent's kernels and stages alone.

Each variant is built from the unedited sources with the flags of
``ccsd_tpu_torch/kernels/build.py`` into ``build/stage_times/``, all in
parallel, and timed as ``chip_smoke.py`` times the kernels (CUDA-graph
replay of 200 launches, CUDA events).  Run from the repo root on a machine
with an NVIDIA H100:

    python3 scripts/gmh_stage_times.py [--parent DIR [--parent-only]]

Prints the card's name and power limit, one line per measurement and,
last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccsd_tpu_torch.kernels import build  # noqa: E402
from ccsd_tpu_torch.kernels.build import SMEM_LIMIT  # noqa: E402
from ccsd_tpu_torch.kernels.gmh_attention import (  # noqa: E402
    H100_SMS, TILE, TILED_MAX_GROUP, channel_group, pair_plan, projection_group, tile_pairs)
from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores_plain, scores_group  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "stage_times")
# the Stage masks of csrc/gmh_common.cuh
NORM_X, PROJECTION, HEAD_SUMS, STORE, LOADS = 1, 2, 4, 8, 16
VARIANTS = {
    "gmh_attention": {"base": 0, "no_norm_x": NORM_X, "no_projection": PROJECTION,
                      "no_head_sums": HEAD_SUMS, "no_store": STORE,
                      "skeleton": NORM_X | PROJECTION | HEAD_SUMS | STORE},
    "gmh_scores": {"base": 0, "no_head_sums": HEAD_SUMS, "no_store": STORE,
                   "no_loads": LOADS},
}
# gmh_projection's variants (its library is gmh_attention's; no_loads is
# built for it alone, and the parent has no such mask)
PROJ_VARIANTS = ("base", "no_norm_x", "no_projection", "skeleton")
# grid's attention layers: (name, B, C, N, F_in, attn, F_out, heads), the
# first with a contiguous adjacency, the later with a channels-last one
PROJ_CASES = [("grid.layers.0", 8, 2, 361, 5, 32, 32, 4),
              ("grid.layers.1", 8, 8, 361, 32, 32, 32, 4)]
# the tile-pair stage's variants (no_loads: this tree only; the parent's
# stage had no such mask) and its instances: (library, product type)
TILED_VARIANTS = ("base", "no_head_sums", "no_store", "no_loads")
TILED_INSTANCES = (("gmh_scores", "bf16"), ("gmh_scores", "f32"), ("gmh_attention", "f32"))


def build_variants(parent_dir, parent_only=False):
    """{(tree, kernel, variant): bound library}, all built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {} if parent_only else {
        ("new", kname, variant): (os.path.join(build.CSRC_DIR, f"{kname}.cu"),
                                  os.path.join(OUT_DIR, f"lib{kname}_{variant}.so"),
                                  [f"-DGMH_ABLATE={mask}"])
        for kname, variants in VARIANTS.items() for variant, mask in variants.items()}
    if not parent_only:
        jobs[("new", "gmh_attention", "no_loads")] = (
            os.path.join(build.CSRC_DIR, "gmh_attention.cu"),
            os.path.join(OUT_DIR, "libgmh_attention_no_loads.so"), [f"-DGMH_ABLATE={LOADS}"])
    if parent_dir:
        for kname, variants in VARIANTS.items():
            src = os.path.join(parent_dir, "ccsd_tpu_torch", "csrc", f"{kname}.cu")
            for variant, mask in variants.items():
                if variant != "no_loads":
                    jobs[("parent", kname, variant)] = (
                        src, os.path.join(OUT_DIR, f"lib{kname}_parent_{variant}.so"),
                        [f"-DGMH_ABLATE={mask}"])
    build.nvcc_parallel(jobs)
    return {key: build.bind(key[1], lib) for key, (_, lib, _) in jobs.items()}


def tiled_group(lib, B, C, N, A):
    """G of a tile-pair launch as a tree's wrapper chooses it (this tree's
    and the parent's alike): C, halved while fewer blocks than SMs or a
    block of G channels does not fit, by that library's own count."""
    return channel_group(B * len(tile_pairs(N)), C, H100_SMS,
                         lambda g: lib.gmh_tiled_scores_smem(A, g) <= SMEM_LIMIT)


def time_tiled_stage(libs, trees, turns, gen, dev, record, checks):
    """The tile-pair score stage at grid's attention layers (TILED_INSTANCES,
    C = 2 and 8): each tree's whole launch in turns, the stages, every G of
    this tree; each output held to its plain version, the maps to exact
    symmetry, and the f32 maps of the two trees to each other."""
    for case in PROJ_CASES:
        name, B, C, N, _, A, O, H = case
        q, k, _, _ = cs.scores_inputs((name, B, C, N, A, H, O), gen, dev)
        qk = torch.randn(B, C, N, 2 * A, generator=gen, device=dev)
        pairs = pair_plan(N, dev)
        for kname, product in TILED_INSTANCES:
            bf16 = product == "bf16"
            qq, kk = (q, k) if kname == "gmh_scores" else (qk[..., :A], qk[..., A:])
            ref = gmh_scores_plain(qq, kk, H, O, bf16)
            tol = cs.bf16_scores_tol(qq, kk, H, O) if bf16 else cs.KERNEL_TOL
            G = {t: tiled_group(libs[(t, kname, "base")], B, C, N, A) for t in trees}
            outs = {}

            def call(tree, variant, g):
                out = torch.empty(B, N, N, C, device=dev)
                a = (qq.data_ptr(), kk.data_ptr(), pairs.data_ptr(), out.data_ptr(), B, C, N,
                     A, H, A // H, g, pairs.shape[0], *qq.stride()[:3], *kk.stride()[:3],
                     math.sqrt(O)) + ((int(bf16),) if kname == "gmh_scores" else ())
                return libs[(tree, kname, variant)].gmh_tiled_scores_run, a, out

            shape = dict(kernel=f"{kname} tile-pair stage", product=product, case=name, C=C)
            for tree in turns:
                fn, a, out = call(tree, "base", G[tree])
                record(fn, a, **shape, tree=tree, G=G[tree], variant="base")
                outs[tree] = out
            for tree, out in outs.items():
                torch.cuda.synchronize()
                abs_err, _, ok = cs.compare(out, ref, tol)
                sym = bool(torch.equal(out, out.transpose(1, 2)))
                row = dict(check=f"{kname} {product} {name}", tree=tree,
                           max_abs_err=abs_err, within_tol=ok, symmetric=sym)
                if tree == "new":
                    fn, a, again = call(tree, "base", G[tree])
                    fn(*a, torch.cuda.current_stream().cuda_stream)
                    torch.cuda.synchronize()
                    row["repeat_bit_identical"] = bool(torch.equal(out, again))
                checks.append(row)
                print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            if len(outs) == 2 and not bf16:
                row = dict(check=f"{kname} {product} {name}", parent_bit_equal=bool(
                    torch.equal(outs["new"], outs["parent"])))
                checks.append(row)
                print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
            for tree in trees:
                for variant in TILED_VARIANTS[1:]:
                    if (tree, kname, variant) in libs:
                        fn, a, _ = call(tree, variant, G[tree])
                        record(fn, a, **shape, tree=tree, G=G[tree], variant=variant)
            if "new" in trees:
                for g in (1, 2, 4, 8):
                    if g <= min(C, TILED_MAX_GROUP) and g != G["new"]:
                        fn, a, _ = call("new", "base", g)
                        record(fn, a, **shape, tree="new", G=g, variant="base", sweep="G")


def parent_projection_group(lib, B, C, N, Fi, A, O):
    """G of the earlier gmh_projection wrapper: 32-row tiles, G halved from C
    while fewer blocks than SMs or a block does not fit."""
    return channel_group(B * -(-N // TILE), C, H100_SMS,
                         lambda g: lib.gmh_projection_smem(N, Fi, A, O, g) <= SMEM_LIMIT)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="an unpacked tree of an earlier commit")
    ap.add_argument("--parent-only", action="store_true",
                    help="with --parent: time the parent's kernels and stages alone")
    opts = ap.parse_args(argv)
    if opts.parent_only and not opts.parent:
        ap.error("--parent-only needs --parent DIR")
    if not torch.cuda.is_available():
        print("gmh_stage_times: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_name_power()
    print(card, flush=True)
    libs = build_variants(opts.parent, opts.parent_only)
    fns = {key: getattr(lib, next(iter(build.SIGNATURES[key[1]]))) for key, lib in libs.items()}
    if opts.parent_only:
        trees, turns = ["parent"], ["parent"]
    else:
        trees = ["new", "parent"] if opts.parent else ["new"]
        turns = ["parent", "new", "new", "parent"] if opts.parent else ["new"]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, checks = [], []

    def launch(fn, args):  # on the current stream, which a graph capture changes
        return fn(*args, torch.cuda.current_stream().cuda_stream)

    def record(fn, args, **kv):
        if launch(fn, args):
            raise RuntimeError(f"launch failed: {kv}")
        kv["us"] = round(1e3 * cs.call_ms(lambda: launch(fn, args))[0], 3)
        rows.append(kv)
        print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)

    B, N, A, O, H = 128, 20, 32, 32, 4
    for C, Fi in ((2, 11), (8, 32)):
        case = ("stage", B, C, N, Fi, A, O, H)
        layouts = {"contiguous": cs.gmh_inputs}
        if C == 8:
            layouts["channels-last"] = cs.gmh_inputs_channels_last
        for layout, mk in layouts.items():
            x, adj, wq, bq, wk, bk, wv, bv, _, _ = mk(case, gen, dev)
            v_out = torch.empty(B, N, C * O, device=dev)
            a_out = torch.empty(B, N, N, C, device=dev)
            args = (x.data_ptr(), adj.data_ptr(), wq.data_ptr(), bq.data_ptr(), wk.data_ptr(),
                    bk.data_ptr(), wv.data_ptr(), bv.data_ptr(), v_out.data_ptr(),
                    a_out.data_ptr(), B, C, N, Fi, A, O, H, A // H, *adj.stride(),
                    math.sqrt(O), 1, 1.0)
            for tree in turns:
                record(fns[(tree, "gmh_attention", "base")], args, kernel="gmh_attention",
                       C=C, adj=layout, tree=tree, variant="base")
            for tree in trees:
                for variant in VARIANTS["gmh_attention"]:
                    if variant != "base":
                        record(fns[(tree, "gmh_attention", variant)], args,
                               kernel="gmh_attention", C=C, adj=layout, tree=tree,
                               variant=variant)

        q, k, _, _ = cs.scores_inputs(("stage", B, C, N, A, H, O), gen, dev)
        out = torch.empty(B, N, N, C, device=dev)
        for bf16 in (1, 0) if "new" in trees else ():
            G0 = scores_group(B, C, N, A, H, bool(bf16))
            runs = [("G", G, "base") for G in (1, 2, 4, 8) if G <= C]
            runs += [("stage", G0, v) for v in VARIANTS["gmh_scores"] if v != "base"]
            for what, G, variant in runs:
                args = (q.data_ptr(), k.data_ptr(), out.data_ptr(), B, C, N, A, H, A // H, G,
                        *q.stride()[:3], *k.stride()[:3], math.sqrt(O), bf16)
                record(fns[("new", "gmh_scores", variant)], args, kernel="gmh_scores",
                       product="bf16" if bf16 else "f32", C=C, G=G, wrapper_G=G0,
                       variant=variant, sweep=what)

    for case in PROJ_CASES:
        _, B, C, N, Fi, A, O, _ = case
        x, adj, deg, wq, bq, wk, bk, wv, bv = cs.proj_inputs(case, gen, dev)
        qk = torch.empty(B, C, N, 2 * A, device=dev)
        v_out = torch.empty(B, N, C * O, device=dev)
        G = {} if opts.parent_only else {"new": projection_group(C, N, Fi, A, O)}
        if opts.parent:
            G["parent"] = parent_projection_group(libs[("parent", "gmh_attention", "base")],
                                                  B, C, N, Fi, A, O)

        def proj(tree, variant, g=None):
            a = (x.data_ptr(), adj.data_ptr(), deg.data_ptr(), wq.data_ptr(), bq.data_ptr(),
                 wk.data_ptr(), bk.data_ptr(), wv.data_ptr(), bv.data_ptr(), qk.data_ptr(),
                 v_out.data_ptr(), B, C, N, Fi, A, O, g or G[tree], *adj.stride(), 1, 1.0)
            return libs[(tree, "gmh_attention", variant)].gmh_projection_run, a

        shape = dict(kernel="gmh_projection", case=case[0], C=C, F_in=Fi,
                     adj="contiguous" if C == 2 else "channels-last")
        for tree in turns:
            record(*proj(tree, "base"), **shape, tree=tree, G=G[tree], variant="base")
        for tree in trees:
            for variant in PROJ_VARIANTS + (("no_loads",) if tree == "new" else ()):
                if variant != "base":
                    record(*proj(tree, variant), **shape, tree=tree, G=G[tree],
                           variant=variant)
        for g in (1, 2, 4, 8) if "new" in trees else ():
            if g <= C and g != G["new"]:
                record(*proj("new", "base", g), **shape, tree="new", G=g, variant="base",
                       sweep="G")
    time_tiled_stage(libs, trees, turns, gen, dev, record, checks)
    print(json.dumps({"card": card, "rows": rows, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
