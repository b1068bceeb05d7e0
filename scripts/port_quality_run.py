"""End-to-end quality run of the port: community_small, train -> sample -> MMD.

Trains ScoreNetworkX and ScoreNetworkA with ``config/community_small.yaml``
as published (5000 epochs, ``use_ema: false`` for sampling) on the JAX
package's community_small graphs (``community_small_adjs(100, seed)``: 80
train, 20 test), then samples the final checkpoint by the JAX sampler's
protocol (20 graphs, one round of 128, 1000 Euler + Langevin steps) at each
sampling seed, on the default (fused fast) path and with
``sample.fused: false``, and scores each run against the test split: the
four graph MMDs and the four lifted-CC MMDs.  Prints one JSON line per
run, the number of graphs in which the two paths' samples differ at each
seed, then per path the mean, min and max of each MMD over the seeds, the
train split scored against the test split (the data's own MMD floor), and
the check of each path's mean graph MMDs against 1.5 times the worst of the
JAX package's three community_small rows (``BASELINE.md``); exits 1 if a
mean misses its bound.

    python3 scripts/port_quality_run.py [--epochs 5000] [--seed 42] \
        [--sample-seeds 12 42 1234] [--folder build/quality_run] [--device cuda]

Runs on CUDA (the kernels) unless ``--device cpu`` (the plain path, a
rehearsal at a few epochs: the 1000 steps take about 2 minutes a run
there).  Checkpoints and logs go under ``--folder``.
Imports torch, numpy and ccsd_tpu_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from ccsd_tpu_torch.data.loader import community_small_adjs, split  # noqa: E402
from ccsd_tpu_torch.sampling.sampler import Sampler  # noqa: E402
from ccsd_tpu_torch.training.trainer import COMMUNITY_SMALL_GRAPHS, Trainer  # noqa: E402
from ccsd_tpu_torch.utils.config import AttrDict, get_config  # noqa: E402

# the JAX package's community_small rows (degree, cluster, orbit, spectral;
# BASELINE.md "From-scratch training quality" and "Quality parity"): its
# scanned trainer, its epoch-loop trainer, the reference's shipped checkpoint
JAX_ROWS = {
    "jax_scanned_trainer": {"degree": 0.056, "cluster": 0.123, "orbit": 0.007, "spectral": 0.176},
    "jax_epoch_loop": {"degree": 0.060, "cluster": 0.074, "orbit": 0.018, "spectral": 0.175},
    "reference_checkpoint": {"degree": 0.071, "cluster": 0.116, "orbit": 0.007,
                             "spectral": 0.175},
}
BOUND_FACTOR = 1.5
BOUNDS = {k: BOUND_FACTOR * max(r[k] for r in JAX_ROWS.values())
          for k in ("degree", "cluster", "orbit", "spectral")}
PATHS = {"default": True, "sample.fused: false": False}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=None, help="default: the config's")
    ap.add_argument("--seed", type=int, default=42, help="dataset, weights and data order")
    ap.add_argument("--sample-seeds", type=int, nargs="+", default=[12, 42, 1234])
    ap.add_argument("--folder", default=os.path.join(ROOT, "build", "quality_run"))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    where = "cpu (plain path)" if on_cpu else card()

    config = AttrDict(get_config("community_small", args.seed, ROOT).to_dict())
    config.folder = args.folder
    if args.epochs is not None:
        config.train.num_epochs = config.train.save_interval = args.epochs
    adjs = community_small_adjs(COMMUNITY_SMALL_GRAPHS, args.seed, int(config.data.max_node_num))
    tr, te = split(len(adjs), float(config.data.test_split))
    train, test = adjs[tr], adjs[te]

    trainer = Trainer(config, device=args.device, adjs=adjs)
    t0 = time.perf_counter()
    name = trainer.train()
    hist = np.asarray(trainer.history["train"])
    emit(run="train", epochs=trainer.epoch, steps=trainer.step,
         seconds=time.perf_counter() - t0, train_steps_per_s=trainer.steps_per_s,
         loss_x=[hist[0][0], hist[-1][0]], loss_adj=[hist[0][1], hist[-1][1]],
         ckpt=trainer.checkpoint_path(f"{name}_final"), card=where)

    runs = {p: [] for p in PATHS}
    graphs = {}  # (path, seed) -> the kept adjacencies
    for path, fused in PATHS.items():
        for s in args.sample_seeds:
            cfg = AttrDict(config.to_dict())
            cfg.ckpt, cfg.sample.seed, cfg.sample.fused = f"{name}_final", s, fused
            res = Sampler(cfg, train, test, device=args.device, log=False).sample()
            if not res["finite"]:
                raise RuntimeError(f"{path}, seed {s}: non-finite sampler output")
            runs[path].append({**res["mmd"], **res["cc_mmd"]})
            graphs[path, s] = res["adj"]
            emit(run="sample", path=path, sample_seed=s, graphs=int(res["adj"].shape[0]),
                 mmd=res["mmd"], cc_mmd=res["cc_mmd"], steps_per_s=res["steps_per_s"],
                 sampling_seconds=res["sampling_time"], eval_seconds=res["eval_seconds"],
                 card=where)

    # the same seed gives both paths the same flags and noise: count the
    # graphs the fused fast path's bf16 head scores changed
    a, b = PATHS
    emit(run="paths_compared", graphs_that_differ={
        s: int((graphs[a, s] != graphs[b, s]).any((1, 2)).sum()) for s in args.sample_seeds})

    floor = Sampler(config, train, test, device=args.device, log=False).evaluate(test, train)
    emit(run="train_vs_test", graphs=[len(train), len(test)], mmd=floor["mmd"],
         cc_mmd=floor["cc_mmd"])

    ok = True
    for path, rows in runs.items():
        keys = list(rows[0])
        vals = {k: [r[k] for r in rows] for k in keys}
        mean = {k: float(np.mean(v)) for k, v in vals.items()}
        within = {k: mean[k] <= BOUNDS[k] for k in BOUNDS}
        ok &= all(within.values())
        emit(run="summary", path=path, sample_seeds=args.sample_seeds, mean=mean,
             min={k: min(v) for k, v in vals.items()}, max={k: max(v) for k, v in vals.items()},
             bounds=BOUNDS, within_bounds=within)
    emit(run="jax_rows", rows=JAX_ROWS, note="the JAX package's MMDs (BASELINE.md), on a TPU")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
