"""End-to-end quality run of the port: train -> sample -> MMD, on
community_small or grid_small.

Trains ScoreNetworkX and ScoreNetworkA with ``config/<config>.yaml`` as
published (5000 epochs) on the JAX package's graphs of that dataset
(``generated_adjs(config, seed)``: 100 graphs, 80 train, 20 test), then
samples the final checkpoint by the JAX sampler's protocol (20 graphs, 1000
steps; community_small: one round of 128, Euler + Langevin, the raw
weights; grid_small: three rounds of 8, Reverse + Langevin, the EMA
weights, as each config says) at each sampling seed, on the default (fused
fast) path and with ``sample.fused: false``, and scores each run against
the test split: the four graph MMDs and the four lifted-CC MMDs.  Prints
one JSON line per run, the number of graphs in which the two paths'
samples differ at each seed, then per path the mean, min and max of each
MMD over the seeds, the train split scored against the test split (the
data's own MMD floor), and the check of each path's mean graph MMDs
against 1.5 times the worst of the JAX package's rows for the config
(``BASELINE.md``); exits 1 if a mean misses its bound.  The bound holds
only for a run of the published epochs: a shorter one (``--epochs``, or
``--train-seconds``, which trains in chunks of 500 epochs and stops before
the next chunk, at the last chunk's pace, would end past that many seconds
of training) is a cut, reported beside the bounds but not held to them.

    python3 scripts/port_quality_run.py [--config community_small|grid_small] \
        [--epochs 5000] [--train-seconds S] [--seed 42] [--sample-seeds 12 42 1234] \
        [--folder build/quality_run] [--device cuda]

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

from ccsd_tpu_torch.data.loader import generated_adjs, split  # noqa: E402
from ccsd_tpu_torch.sampling.sampler import Sampler  # noqa: E402
from ccsd_tpu_torch.training.trainer import Trainer  # noqa: E402
from ccsd_tpu_torch.utils.config import AttrDict, get_config  # noqa: E402

# the JAX package's rows (degree, cluster, orbit, spectral; BASELINE.md),
# its MMDs, taken on a TPU v5e.  community_small ("From-scratch training
# quality" and "Quality parity"): its scanned trainer, its epoch-loop
# trainer, the reference's shipped checkpoint; grid_small ("From-scratch
# sweep completed", BASELINE.md:445): its scanned trainer at 5000 epochs
JAX_ROWS = {
    "community_small": {
        "jax_scanned_trainer": {"degree": 0.056, "cluster": 0.123, "orbit": 0.007,
                                "spectral": 0.176},
        "jax_epoch_loop": {"degree": 0.060, "cluster": 0.074, "orbit": 0.018,
                           "spectral": 0.175},
        "reference_checkpoint": {"degree": 0.071, "cluster": 0.116, "orbit": 0.007,
                                 "spectral": 0.175},
    },
    "grid_small": {
        "jax_scanned_trainer": {"degree": 0.0073, "cluster": 0.042, "orbit": 0.024,
                                "spectral": 0.193},
    },
}
BOUND_FACTOR = 1.5
CHUNK_EPOCHS = 500  # --train-seconds trains in chunks of this many epochs
PATHS = {"default": True, "sample.fused: false": False}


def bounds(name: str) -> dict:
    """1.5 times the worst of the config's JAX rows, per graph MMD."""
    rows = JAX_ROWS[name].values()
    return {k: BOUND_FACTOR * max(r[k] for r in rows)
            for k in ("degree", "cluster", "orbit", "spectral")}


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
    ap.add_argument("--config", default="community_small", choices=sorted(JAX_ROWS))
    ap.add_argument("--epochs", type=int, default=None, help="default: the config's")
    ap.add_argument("--train-seconds", type=float, default=None,
                    help="train in chunks of 500 epochs within this many seconds")
    ap.add_argument("--seed", type=int, default=42, help="dataset, weights and data order")
    ap.add_argument("--sample-seeds", type=int, nargs="+", default=[12, 42, 1234])
    ap.add_argument("--folder", default=os.path.join(ROOT, "build", "quality_run"))
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    where = "cpu (plain path)" if on_cpu else card()

    config = AttrDict(get_config(args.config, args.seed, ROOT).to_dict())
    config.folder = args.folder
    published = int(config.train.num_epochs)
    if args.epochs is not None:
        config.train.num_epochs = config.train.save_interval = args.epochs
    BOUNDS = bounds(args.config)
    adjs = generated_adjs(args.config, args.seed, int(config.data.max_node_num))
    tr, te = split(len(adjs), float(config.data.test_split))
    train, test = adjs[tr], adjs[te]

    trainer = Trainer(config, device=args.device, adjs=adjs)
    t0 = time.perf_counter()
    target = int(config.train.num_epochs)
    chunk = CHUNK_EPOCHS if args.train_seconds else target
    while trainer.epoch < target:
        t_chunk = time.perf_counter()
        config.train.num_epochs = min(target, trainer.epoch + chunk)
        name = trainer.train()
        spent, last = time.perf_counter() - t0, time.perf_counter() - t_chunk
        if args.train_seconds and spent + last > args.train_seconds:
            break
    if trainer.epoch < target:
        emit(run="train_cut", epochs=trainer.epoch, published_epochs=published,
             train_seconds=args.train_seconds,
             note=f"the next {CHUNK_EPOCHS} epochs would not fit")
    held = trainer.epoch >= published
    hist = np.asarray(trainer.history["train"])
    emit(run="train", config=args.config, epochs=trainer.epoch, published_epochs=published,
         steps=trainer.step,
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
            emit(run="sample", path=path, sample_seed=s, weights=res["weights"],
                 graphs=int(res["adj"].shape[0]),
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
        ok &= all(within.values()) or not held
        emit(run="summary", config=args.config, path=path, sample_seeds=args.sample_seeds,
             mean=mean, min={k: min(v) for k, v in vals.items()},
             max={k: max(v) for k, v in vals.items()}, bounds=BOUNDS, within_bounds=within,
             held_to_bounds=held, epochs=trainer.epoch,
             published_epochs=published)
    emit(run="jax_rows", rows=JAX_ROWS[args.config],
         note="the JAX package's MMDs (BASELINE.md), on a TPU")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
