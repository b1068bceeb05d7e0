"""Command-line entry point of the port (graph sampling).

Usage:
    python -m ccsd_tpu_torch.cli --type sample --config community_small \
        [--seed 42] [--folder ./] [--device cuda|cpu] [--num-samples 128] \
        [--train-adjs adjs.npy] [--out samples.npz]

The node counts come from ``--train-adjs`` (a (M, N, N) numpy array of
padded training adjacencies); without it, community_small draws them from
its generation recipe.  The config's ``sample.fused`` and ``sample.fast``
(both on when absent) pick the network path, as in ``Sampler``.  Training
is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ccsd_tpu_torch",
                                description="PyTorch/CUDA graph sampling")
    p.add_argument("--type", required=True, choices=["sample"])
    p.add_argument("--config", required=True, help="config/<name>.yaml")
    p.add_argument("--folder", default="./", help="root of config/ and checkpoints/")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--train-adjs", default=None, help=".npy of (M, N, N) adjacencies")
    p.add_argument("--out", default=None, help="write adj/x/flags to this .npz")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ccsd_tpu_torch.data.loader import community_small_adjs
    from ccsd_tpu_torch.sampling.sampler import Sampler
    from ccsd_tpu_torch.utils.config import get_config

    config = get_config(args.config, args.seed, args.folder)
    if args.train_adjs:
        train_adjs = np.load(args.train_adjs)
    elif str(config.data.data) == "community_small":
        train_adjs = community_small_adjs(100, np.random.default_rng(args.seed),
                                          int(config.data.max_node_num))
    else:
        raise SystemExit(f"--train-adjs is required for {config.data.data}")
    res = Sampler(config, train_adjs, device=args.device).sample(args.num_samples)
    if args.out:
        np.savez(args.out, adj=res["adj"], x=res["x"], flags=res["flags"])
    print(json.dumps({
        "samples": int(res["adj"].shape[0]),
        "finite": res["finite"],
        "mean_edges": float(res["adj"].sum((1, 2)).mean() / 2),
        "sampling_time": res["sampling_time"],
        "steps_per_s": res["steps_per_s"],
        "weights": res["weights"],
        "device": res["device"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
