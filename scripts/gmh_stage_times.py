"""Where the time of the two attention kernels goes, on the card.

Times ``gmh_attention`` and ``gmh_scores`` (both product types) at the
community_small layer shapes (B = 128, N = 20, attn = F_out = 32, 4 heads;
C = 2 on F_in = 11 and C = 8 on F_in = 32):

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
  show what the wrapper's choice of G gives.

Each variant is built from the unedited sources with the flags of
``ccsd_tpu_torch/kernels/build.py`` into ``build/stage_times/``, all in
parallel, and timed as ``chip_smoke.py`` times the kernels (CUDA-graph
replay of 200 launches, CUDA events).  Run from the repo root on a machine
with an NVIDIA H100:

    python3 scripts/gmh_stage_times.py

Prints one line per measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ccsd_tpu_torch.kernels import build  # noqa: E402
from ccsd_tpu_torch.kernels.gmh_scores import scores_group  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "stage_times")
# the Stage masks of csrc/gmh_common.cuh
NORM_X, PROJECTION, HEAD_SUMS, STORE = 1, 2, 4, 8
VARIANTS = {
    "gmh_attention": {"base": 0, "no_norm_x": NORM_X, "no_projection": PROJECTION,
                      "no_head_sums": HEAD_SUMS, "no_store": STORE,
                      "skeleton": NORM_X | PROJECTION | HEAD_SUMS | STORE},
    "gmh_scores": {"base": 0, "no_head_sums": HEAD_SUMS, "no_store": STORE},
}


def build_variants():
    """{(kernel, variant): bound launcher}, all built in parallel."""
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = {(kname, variant): (os.path.join(build.CSRC_DIR, f"{kname}.cu"),
                               os.path.join(OUT_DIR, f"lib{kname}_{variant}.so"),
                               [f"-DGMH_ABLATE={mask}"])
            for kname, variants in VARIANTS.items() for variant, mask in variants.items()}
    build.nvcc_parallel(jobs)
    return {(kname, variant): getattr(build.bind(kname, lib), next(iter(build.SIGNATURES[kname])))
            for (kname, variant), (_, lib, _) in jobs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("gmh_stage_times: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.smi_name_power()
    print(card, flush=True)
    fns = build_variants()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

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
            for variant in VARIANTS["gmh_attention"]:
                record(fns[("gmh_attention", variant)], args, kernel="gmh_attention", C=C,
                       adj=layout, variant=variant)

        q, k, _, _ = cs.scores_inputs(("stage", B, C, N, A, H, O), gen, dev)
        out = torch.empty(B, N, N, C, device=dev)
        for bf16 in (1, 0):
            G0 = scores_group(B, C, N, A, H, bool(bf16))
            runs = [("G", G, "base") for G in (1, 2, 4, 8) if G <= C]
            runs += [("stage", G0, v) for v in VARIANTS["gmh_scores"] if v != "base"]
            for what, G, variant in runs:
                args = (q.data_ptr(), k.data_ptr(), out.data_ptr(), B, C, N, A, H, A // H, G,
                        *q.stride()[:3], *k.stride()[:3], math.sqrt(O), bf16)
                record(fns[("gmh_scores", variant)], args, kernel="gmh_scores",
                       product="bf16" if bf16 else "f32", C=C, G=G, wrapper_G=G0,
                       variant=variant, sweep=what)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
