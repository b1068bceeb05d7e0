"""Whether a dense CC model's reverse diffusion stays in f32 as it trains.

Trains a CC config through ``Trainer`` on its generated dataset with the
sampler's SDEs set to ``--steps`` steps (the loss does not read them),
stopping at each of ``--epochs``; at each stop samples the checkpoint
through ``Sampler.sample`` on both paths, one round at the protocol's
batch (``sample.max_samples``, evaluation off) at each ``--score-dtype``
(f32 unless said; ``sample.score_dtype``), and prints one JSON line a run:
finite or not, the last training losses, steps/s, mean edges and cells
per CC.

    python3 scripts/cc_finite_sweep.py --config grid_small_CC \\
        --epochs 5 10 20 30 50 --steps 50 [--score-dtype f32 bf16]

A config whose ``model.num_layers_mlp`` is null (grid_small_Base_CC), with
which neither package builds ScoreNetworkF, runs with 1, as the smoke
does.  Runs on the card; imports torch, numpy and ccsd_tpu_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--epochs", type=int, nargs="+", default=[5, 10, 20, 30, 50])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--folder", default=os.path.join(ROOT, "build", "cc_finite_sweep"))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--score-dtype", nargs="+", default=["f32"], choices=["f32", "bf16"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from ccsd_tpu_torch.data.loader import generated_adjs, split
    from ccsd_tpu_torch.sampling.sampler import Sampler, sampling_rounds
    from ccsd_tpu_torch.training.trainer import Trainer
    from ccsd_tpu_torch.utils.config import get_config

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    folder = os.path.join(os.path.abspath(args.folder), args.config)
    shutil.rmtree(folder, ignore_errors=True)

    def config(epochs):
        c = get_config(args.config, seed=0, folder=ROOT)
        c.folder = folder
        c.train.name, c.train.num_epochs, c.train.save_interval = "sweep", epochs, epochs
        if c.model.get("num_layers_mlp") is None:
            c.model.num_layers_mlp = 1
        for k in ("x", "adj", "rank2"):
            c.sde[k].num_scales = args.steps
        return c

    trainer = Trainer(config(args.epochs[-1]), device=args.device)
    d = trainer.config.data
    adjs = generated_adjs(str(d.data), int(trainer.config.get("seed", 42)), int(d.max_node_num))
    tr, te = split(len(adjs), float(d.test_split))
    batch, _ = sampling_rounds(int(d.batch_size), len(adjs[te]),
                               trainer.config.sample.get("divide_batch"))
    for epochs in args.epochs:
        t0 = time.perf_counter()
        trainer.config.train.num_epochs = epochs
        ckpt = f"{trainer.train()}_final"
        seconds = time.perf_counter() - t0
        for score_dtype, fused in ((sd, f) for sd in args.score_dtype for f in (True, False)):
            cfg = config(epochs)
            cfg.ckpt, cfg.sample.fused = ckpt, fused
            cfg.sample.max_samples, cfg.sample.eval = batch, False
            cfg.sample.score_dtype = score_dtype
            res = Sampler(cfg, adjs[tr], adjs[te], device=args.device, log=False).sample()
            print(json.dumps({
                "config": args.config, "epochs": epochs, "fused": fused,
                "score_dtype": res["score_dtype"],
                "train_seconds": seconds, "loss_last": trainer.history["train"][-1],
                "weights": res["weights"], "batch": batch, "steps": args.steps,
                "finite": res["finite"], "steps_per_s": res["steps_per_s"],
                "mean_edges": float(np.asarray(res["adj"]).sum((1, 2)).mean() / 2),
                "cells_per_cc": res["cells_per_cc"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
