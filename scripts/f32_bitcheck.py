"""Whether the f32 forward kernels give the same bits as another checkout's.

Runs the f32 variants of the four forward kernels that take bf16 too
(``gcn_aggregate``, ``gmh_attention``, ``channel_agg`` and ``gmh_scores``
with f32 and with bf16 products) of this checkout and of the checkout at
``--other`` on the same seeded inputs, each tree in a process of its own
(every kernel built from that tree's sources), and compares each output
bit for bit.  The shapes are community_small_CC's layers (N = 20), grid_small's
(N = 49), both whole-graph designs, and N = 100 (the tiled designs), the
adjacency both contiguous and in the channels-last view the path gives a
later layer.  Prints one JSON line a case and exits 1 on any difference.

    mkdir -p build/parent && git archive PARENT | tar -x -C build/parent
    python3 scripts/f32_bitcheck.py --other build/parent

Runs on the card; imports torch and each tree's ccsd_tpu_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, N, F_in, F_out) of gcn_aggregate; (B, C, N, F_in, A, O, heads) of the
# attention kernels, whose channel_agg takes (B, C, N, F_in)
GCN_CASES = [(16, 20, 11, 32), (8, 49, 32, 32), (2, 100, 10, 16)]
GMH_CASES = [(16, 2, 20, 11, 16, 16, 4), (16, 8, 20, 32, 16, 16, 4), (8, 8, 49, 32, 16, 16, 4),
             (2, 4, 100, 16, 16, 16, 4)]


def outputs(tree: str) -> dict:
    """Every case's outputs from the kernels of ``tree``, copied to the host."""
    sys.path.insert(0, tree)
    import torch

    import ccsd_tpu_torch
    from ccsd_tpu_torch.kernels.build import build_all
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg
    from ccsd_tpu_torch.kernels.gcn import gcn_aggregate
    from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores

    here = os.path.dirname(os.path.dirname(os.path.abspath(ccsd_tpu_torch.__file__)))
    if here != os.path.abspath(tree):
        raise RuntimeError(f"ccsd_tpu_torch imported from {here}, not {tree}")
    build_all(["gcn_aggregate", "gmh_attention", "channel_agg", "gmh_scores"])
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def sym(a):
        return (a + a.transpose(-1, -2)) / 2

    out = {}
    with torch.no_grad():
        for B, N, Fi, Fo in GCN_CASES:
            x, adj, w, b = randn(B, N, Fi), sym(randn(B, N, N)), randn(Fi, Fo), randn(Fo)
            out[f"gcn_aggregate B{B} N{N} F{Fi}x{Fo}"] = [gcn_aggregate(x, adj, w, b)]
        for B, C, N, Fi, A, O, H in GMH_CASES:
            x, adj = randn(B, N, Fi), sym(randn(B, C, N, N))
            views = {"contiguous": adj,
                     "channels-last": adj.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)}
            ws = [randn(C, Fi, A), randn(C, A), randn(C, Fi, A), randn(C, A), randn(C, Fi, O),
                  randn(C, O)]
            qkv = randn(C, B, N, 2 * A + O).transpose(0, 1)
            case = f"B{B} C{C} N{N} F{Fi} A{A} O{O} H{H}"
            for layout, a in views.items():
                out[f"gmh_attention {case} {layout}"] = list(gmh_attention(x, a, *ws, H, O))
                out[f"channel_agg {case} {layout}"] = [channel_agg(a, x)]
                out[f"channel_agg bf16 rounding {case} {layout}"] = [channel_agg(a, x, True)]
            for bf16 in (False, True):
                out[f"gmh_scores {'bf16' if bf16 else 'f32'} products {case}"] = [
                    gmh_scores(qkv[..., :A], qkv[..., A:2 * A], H, O, bf16=bf16)]
    torch.cuda.synchronize()
    return {k: [t.cpu() for t in v] for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the checkout to compare with")
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if args.dump:  # one tree's side, in its own process
        torch.save(outputs(args.tree), args.dump)
        return 0
    trees = {"this": ROOT, "other": os.path.abspath(args.other)}
    res = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for name, tree in trees.items():
            path = os.path.join(tmp, f"{name}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), "--other", args.other,
                            "--tree", tree, "--dump", path], check=True)
            res[name] = torch.load(path)
    differ = 0
    for case, mine in res["this"].items():
        theirs = res["other"][case]
        same = all(torch.equal(a, b) for a, b in zip(mine, theirs))
        differ += not same
        print(json.dumps({"case": case, "bit_identical": same,
                          "max_abs_diff": max(float((a - b).abs().max())
                                              for a, b in zip(mine, theirs))}), flush=True)
    print(json.dumps({"cases": len(res["this"]), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
