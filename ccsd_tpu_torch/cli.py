"""Command-line entry point of the port (graph and CC training and sampling).

Usage:
    python -m ccsd_tpu_torch.cli --type train --config community_small \
        [--seed 42] [--folder ./] [--device cuda|cpu] [--train-adjs adjs.npy] \
        [--resume NAME]
    python -m ccsd_tpu_torch.cli --type sample --config community_small \
        [--seed 42] [--folder ./] [--device cuda|cpu] [--num-samples 128] \
        [--train-adjs adjs.npy] [--out samples.npz] [--ckpt NAME] \
        [--score-dtype bf16|f32] [--dtype bf16|f32]

The dataset is ``--train-adjs`` (a (M, N, N) numpy array of padded
adjacencies); without it, community_small, grid_small and grid generate
the JAX package's 100 graphs from the seed (the other datasets need
``--train-adjs``: their source files are not in the tree).  Training
writes ``<folder>/checkpoints/<data>/
<train.name>_<time>_final.pth`` (``--resume NAME`` continues the run saved
as NAME) and prints one JSON line: epochs, the last epoch's train and test
losses, train steps/s and the checkpoint.  Sampling takes the node counts
from the dataset's train split (all but the first ``int(test_split * M)``
graphs, as training splits it and the JAX sampler draws) and follows the
JAX sampler's protocol against the test split (the first graphs; the same
``--seed`` gives the split the training run held out): ``len(test)``
graphs unless ``--num-samples`` says otherwise, drawn from the seed
``sample.seed``, scored by the four graph MMDs and, where the config sets
``data.lifting_procedure``, the four lifted-CC MMDs; it prints one JSON
line with both (``mmd``, ``cc_mmd``).  The config's ``sample.fused`` and
``sample.fast`` (both on when absent) pick the network path, as in
``Sampler``, and ``ckpt`` the weights (a ``_final`` checkpoint of a port
run, for one; ``--ckpt NAME`` sets it).  ``--score-dtype`` sets
``sample.score_dtype`` (the score networks in bf16, f32 scores) and
``--dtype`` ``sample.dtype`` (the bf16 reverse diffusion carry); the JSON
line names both as resolved.  A CC config (``--config community_small_CC``) trains the
three networks on the graphs and their lift, and samples CCs: its JSON
line adds ``cells_per_cc`` (its ``cc_mmd`` holds the CC MMDs), and
``--out`` the rank-2 incidences.  Its default ``sample.score_dtype`` is
bf16, as in the JAX package (``--score-dtype f32`` for f32).  A two-stage
config (``--config community_small_CC_two_stage``: ``train.two_stage`` and
``sample.two_stage``) trains with ``TwoStageTrainer`` (one full-batch step
an epoch, no test loss) and samples with ``TwoStageSampler`` (graphs, the
bridge, then F over each graph's candidate cells); its JSON line adds
``cells_per_cc``, each round's ``k_max``, each stage's steps/s and
finiteness and stage 2's margin to overflow (``stage2_finite_steps``,
``stage2_max_abs``: an overflowed F quantizes to every candidate), and
``--num-samples`` sets ``sample.n_samples``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ccsd_tpu_torch",
                                description="PyTorch/CUDA graph and CC training and sampling")
    p.add_argument("--type", required=True, choices=["train", "sample"])
    p.add_argument("--config", required=True, help="config/<name>.yaml")
    p.add_argument("--folder", default="./", help="root of config/ and checkpoints/")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--num-samples", type=int, default=None)
    p.add_argument("--train-adjs", default=None, help=".npy of (M, N, N) adjacencies")
    p.add_argument("--out", default=None, help="write adj/x/flags[/rank2] to this .npz")
    p.add_argument("--resume", default=None, help="checkpoint name to resume training from")
    p.add_argument("--ckpt", default=None, help="checkpoint name to sample from")
    p.add_argument("--score-dtype", default=None,
                   help="sample.score_dtype: bf16 or f32 (default: bf16 for "
                        "community_small_CC and ego_small_CC, else f32)")
    p.add_argument("--dtype", default=None,
                   help="sample.dtype: bf16 for the bf16 reverse diffusion carry (default f32)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ccsd_tpu_torch.data.loader import split
    from ccsd_tpu_torch.sampling.sampler import get_sampler_from_config
    from ccsd_tpu_torch.training.trainer import dataset_adjs, get_trainer_from_config
    from ccsd_tpu_torch.utils.config import get_config

    config = get_config(args.config, args.seed, args.folder)
    if args.ckpt:
        config.ckpt = args.ckpt
    if args.score_dtype:
        config.sample.score_dtype = args.score_dtype
    if args.dtype:
        config.sample.dtype = args.dtype
    try:
        adjs = dataset_adjs(config, np.load(args.train_adjs) if args.train_adjs else None)
    except ValueError:
        raise SystemExit(f"--train-adjs is required for {config.data.data}")
    if args.type == "train":
        trainer = get_trainer_from_config(config, device=args.device, adjs=adjs)
        if args.resume:
            trainer.load_checkpoint(args.resume)
        name = trainer.train()
        names = trainer.names
        last = {k: h[-1] if h else [float("nan")] * len(names)
                for k, h in trainer.history.items()}
        print(json.dumps({
            "epochs": trainer.epoch,
            "steps": trainer.step,
            **{f"{k}_loss_{n}": v for k in last for n, v in zip(names, last[k])},
            "steps_per_s": trainer.steps_per_s,
            "ckpt": f"{name}_final",
            "ckpt_path": trainer.checkpoint_path(f"{name}_final"),
            "device": str(trainer.device),
        }))
        return 0
    tr, te = split(len(adjs), float(config.data.test_split))
    sampler = get_sampler_from_config(config, adjs[tr], adjs[te], device=args.device)
    res = sampler.sample(args.num_samples)
    if args.out:
        extra = {"rank2": res["rank2"]} if "rank2" in res else {}
        np.savez(args.out, adj=res["adj"], x=res["x"], flags=res["flags"], **extra)
    cc = {k: res[k] for k in ("cells_per_cc", "k_max", "stage1_steps_per_s",
                              "stage2_steps_per_s", "finite_stages", "stage2_finite_steps",
                              "stage2_max_abs", "rank2_counts") if k in res}
    print(json.dumps({
        "samples": int(res["adj"].shape[0]),
        "finite": res["finite"],
        "mean_edges": float(res["adj"].sum((1, 2)).mean() / 2),
        "sampling_time": res["sampling_time"],
        "steps_per_s": res["steps_per_s"],
        "mmd": res.get("mmd"),
        "cc_mmd": res.get("cc_mmd"),
        **cc,
        "eval_seconds": res.get("eval_seconds"),
        "weights": res["weights"],
        "device": res["device"],
        **{k: res[k] for k in ("score_dtype", "dtype", "note") if k in res},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
