"""Where the time of the two normalising kernels goes, on the card.

Times ``channel_agg`` and ``gcn_aggregate`` at the community_small layer
shapes (B = 128, N = 20: ``gcn_aggregate`` F_in 11 and 32 to F_out 32;
``channel_agg`` C = 2 on F = 11 with a contiguous adjacency, C = 8 on
F = 32 with the channels-last adjacency a later layer passes, and
contiguous), and at grid's (B = 8, N = 361; there the kernels read the
degrees of a ``gcn_degrees`` launch, made once outside the timed loop and
timed on its own):

* each kernel whole, and with stages removed: a build with
  ``-DGCN_ABLATE=<mask>`` (``csrc/gcn_common.cuh``) removes the loads (a
  zero fill in their place), the degrees (d = 1, not applied), the product
  A (d X), the projection (gcn_aggregate's (.) W) or the store;
  ``loads_only`` removes all but the loads, ``empty`` everything but the
  launch and the barriers;
* with ``--parent DIR``, a tree unpacked from the commit before the
  redesign (``git archive <commit> | tar -x -C DIR``): its two kernels the
  same way, their stages removed by exact edits of their source lines
  (those sources have no ablation mask; the script stops if a line is not
  found), and the fused layer's aggregation as that tree ran it,
  ``gcn_norm`` followed by its ``channel_agg`` on the normalised matrix.

Each variant is built with the flags of ``ccsd_tpu_torch/kernels/build.py``
into ``build/stage_times/``, all in parallel, and timed as ``chip_smoke.py``
times the kernels (CUDA-graph replay of 200 launches, CUDA events).  Run
from the repo root on a machine with an NVIDIA H100:

    python3 scripts/gcn_stage_times.py [--parent DIR]

Prints the card's name and power limit, one line per measurement and,
last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccsd_tpu_torch.kernels import build  # noqa: E402
from ccsd_tpu_torch.kernels.gcn import gcn_degrees, gcn_norm, rows_per_block  # noqa: E402

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
}
# the earlier kernels' stages, as (source line, its replacement) edits
PARENT_EDITS = {
    "channel_agg": {
        "loads": [("sN[i] = nb[i];", "sN[i] = 0.f;"), ("sX[i] = xb[i];", "sX[i] = 0.f;")],
        "product": [("for (int m = 0; m < N; ++m) s = fmaf(row[m], sX[m * F + f], s);", "")],
        "store": [("ob[i] = s;", "(void)s;")],
    },
    "gcn_aggregate": {
        "loads": [("? loop : ab[i];", "? loop : 0.f;"), ("sX[i] = xb[i];", "sX[i] = 0.f;")],
        "degrees": [("sD[r] = 1.0f / sqrtf(fmaxf(s, 1.0f));", "sD[r] = 1.0f;")],
        "projection": [("for (int k = 0; k < Fi; ++k) s = fmaf(sX[r * Fi + k], "
                        "__ldg(w + k * Fo + f), s);", "")],
        "product": [("for (int j = 0; j < N; ++j) s = fmaf(sA[r * N + j] * sD[j], "
                     "sXW[j * Fo + f], s);", "")],
        "store": [("ob[i] = v;", "(void)v;")],
    },
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SYMBOLS = {  # the earlier C entry points
    "channel_agg": ("channel_agg_f32", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "gcn_aggregate": ("gcn_aggregate_f32", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
}


def parent_sources(parent_dir):
    """{(kernel, variant): source path}: the earlier sources with the
    stages of each variant edited out."""
    out = {}
    src_dir = os.path.join(OUT_DIR, "parent_src")
    os.makedirs(src_dir, exist_ok=True)
    for kname, stages in PARENT_EDITS.items():
        with open(os.path.join(parent_dir, "ccsd_tpu_torch", "csrc", f"{kname}.cu")) as f:
            text = f.read()
        variants = {"base": [], **{f"no_{s}": [s] for s in stages}, "empty": list(stages)}
        for variant, removed in variants.items():
            edited = text
            for stage in removed:
                for old, new in stages[stage]:
                    if edited.count(old) != 1:
                        raise RuntimeError(f"{kname}: line {old!r} not found once in the parent")
                    edited = edited.replace(old, new)
            path = os.path.join(src_dir, f"{kname}_{variant}.cu")
            with open(path, "w") as f:
                f.write(edited)
            out[(kname, variant)] = path
    return out


def build_variants(parent_dir):
    """{(tree, kernel, variant): bound launcher}, all built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {("new", kname, variant): (os.path.join(build.CSRC_DIR, f"{kname}.cu"),
                                      os.path.join(OUT_DIR, f"lib{kname}_new_{variant}.so"),
                                      [f"-DGCN_ABLATE={mask}"])
            for kname, variants in VARIANTS.items() for variant, mask in variants.items()}
    if parent_dir:
        for (kname, variant), src in parent_sources(parent_dir).items():
            jobs[("parent", kname, variant)] = (
                src, os.path.join(OUT_DIR, f"lib{kname}_parent_{variant}.so"), [])
    logs = build.nvcc_parallel(jobs)
    fns = {}
    for (tree, kname, variant), (_, lib, _) in jobs.items():
        if variant == "base":
            print(f"ptxas {tree} {kname}: " + " | ".join(
                ln.split("info    : ")[-1].strip()
                for ln in logs[(tree, kname, variant)].splitlines() if "Used" in ln), flush=True)
        if tree == "new":
            fn = getattr(build.bind(kname, lib), next(iter(build.SIGNATURES[kname])))
        else:
            sym, argtypes = PARENT_SYMBOLS[kname]
            fn = getattr(ctypes.CDLL(lib), sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(tree, kname, variant)] = fn
    return fns


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="an unpacked tree of the commit before the redesign")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gcn_stage_times: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_name_power()
    print(card, flush=True)
    fns = build_variants(args.parent)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def stream():  # the current stream, which a graph capture changes
        return torch.cuda.current_stream().cuda_stream

    def record(run, **kv):
        run()
        torch.cuda.synchronize()
        kv["us"] = round(1e3 * cs.call_ms(run)[0], 3)
        rows.append(kv)
        print(" ".join(f"{k}={v}" for k, v in kv.items()), flush=True)

    def checked(fn, *a):
        def run():
            if fn(*a, stream()):
                raise RuntimeError("launch failed")
        return run

    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    # channel_agg: (B, C, N, F, adjacency layout)
    for B, C, N, F, layout in ((128, 2, 20, 11, "contiguous"), (128, 8, 20, 32, "channels-last"),
                               (128, 8, 20, 32, "contiguous"), (8, 2, 361, 5, "contiguous"),
                               (8, 8, 361, 32, "channels-last")):
        adj, x = cs.agg_inputs(("stage", B, C, N, F), gen, dev)
        if layout == "channels-last":
            adj = cs.channels_last(adj)
        out = torch.empty(B, C, N, F, device=dev)
        r = rows_per_block(N)
        deg = gcn_degrees(adj) if r < N else None
        shape = dict(kernel="channel_agg", B=B, C=C, N=N, F=F, adj=layout)
        if deg is not None:
            record(lambda: gcn_degrees(adj), **shape, tree="new", variant="gcn_degrees")
        for variant in VARIANTS["channel_agg"]:
            record(checked(fns[("new", "channel_agg", variant)], adj.data_ptr(), x.data_ptr(),
                           ptr(deg), out.data_ptr(), B, C, N, F, *adj.stride(), r, 0),
                   **shape, tree="new", variant=variant)
        if args.parent and N <= 64:
            norm = gcn_norm(adj.contiguous())
            for variant in ("base", "no_loads", "no_product", "no_store", "empty"):
                record(checked(fns[("parent", "channel_agg", variant)], norm.data_ptr(),
                               x.data_ptr(), out.data_ptr(), B, C * N, N, F),
                       **shape, tree="parent", variant=variant)
            base = fns[("parent", "channel_agg", "base")]

            def layer_before():  # the fused layer's aggregation in the parent
                n = gcn_norm(adj.contiguous())
                base(n.data_ptr(), x.data_ptr(), out.data_ptr(), B, C * N, N, F, stream())

            record(layer_before, **shape, tree="parent", variant="gcn_norm_then_kernel")

    # gcn_aggregate: (B, N, F_in, F_out)
    for B, N, Fi, Fo in ((128, 20, 11, 32), (128, 20, 32, 32), (8, 361, 5, 32),
                         (8, 361, 32, 32)):
        x, adj, w, b, _ = cs.gcn_inputs(("stage", B, N, Fi, Fo, 1.0), gen, dev)
        out = torch.empty(B, N, Fo, device=dev)
        r = rows_per_block(N)
        deg = gcn_degrees(adj[:, None]) if r < N else None
        shape = dict(kernel="gcn_aggregate", B=B, N=N, F_in=Fi, F_out=Fo)
        if deg is not None:
            record(lambda: gcn_degrees(adj[:, None]), **shape, tree="new", variant="gcn_degrees")
        for variant in VARIANTS["gcn_aggregate"]:
            record(checked(fns[("new", "gcn_aggregate", variant)], x.data_ptr(), adj.data_ptr(),
                           ptr(deg), w.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, Fi, Fo,
                           r, 1, 1.0),
                   **shape, tree="new", variant=variant)
        if args.parent and N <= 64:
            for variant in ("base", *(f"no_{s}" for s in PARENT_EDITS["gcn_aggregate"]),
                            "empty"):
                record(checked(fns[("parent", "gcn_aggregate", variant)], x.data_ptr(),
                               adj.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                               B, N, Fi, Fo, 1, 1.0),
                       **shape, tree="parent", variant=variant)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
