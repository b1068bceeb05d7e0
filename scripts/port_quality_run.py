"""End-to-end quality run of the port: train -> sample -> MMD, on
community_small, grid_small, grid (N = 361), community_small_CC,
community_small_Base_CC, grid_small_CC (dense, E = 1176, K = 18,424), or
the two-stage CC model (community_small_CC_two_stage,
grid_small_CC_two_stage).

Trains the config's networks (ScoreNetworkX and ScoreNetworkA; for
the dense CC configs ScoreNetworkA_CC or ScoreNetworkA_Base_CC and
ScoreNetworkF on the graphs'
lift; the two-stage configs the graph networks and the dynamic-universe F
through ``TwoStageTrainer``) with ``config/<config>.yaml`` as published
(5000 epochs; community_small_CC_two_stage 3000) on the JAX package's
graphs of that dataset (``generated_adjs(data, seed)``: 100 graphs, 80
train, 20 test), then
samples the final checkpoint by the JAX sampler's protocol (20 graphs, 1000
steps; community_small: one round of 128, Euler + Langevin, the raw
weights; grid_small and grid: three rounds of 8, Reverse + Langevin, the
EMA weights, as each config says; grid's lifted-CC MMDs are skipped at
7.8e6 candidate cells, as the JAX sampler skips them) at each sampling seed, on the default (fused
fast) path and with ``sample.fused: false``, and scores each run against
the test split: the four graph MMDs and the four lifted-CC MMDs (CC mode:
the four CC MMDs of the generated complexes, and their cells per CC; a
run whose output left f32 has its MMDs not measured; the
two-stage configs sample through ``TwoStageSampler``, which keeps every
generated CC, and print each stage's steps/s, each round's K_max and
stage 2's margin to overflow: the steps its F stayed finite and its
largest finite |F|; a run whose F overflowed has its CC MMDs and cells
per CC not measured, since ``quantize`` maps NaN to 1 and every candidate
would become a cell).
Every run samples at ``sample.score_dtype: f32`` unless ``--score-dtype``
names others (``--score-dtype f32 bf16``: each checkpoint scored once in
each, on the same seeds; bf16 is the JAX package's default for
community_small_CC, whose f32 rows are the bar all the same).  Prints
one JSON line per run, the number of graphs in which the two paths'
samples differ at each seed, then per path the mean, min and max of each
MMD over the seeds, the train split scored against the test split (the
data's own MMD floor), and the check of each path's mean graph MMDs
(and, for the two-stage configs, the Hodge MMD) against 1.5 times the
worst of the JAX package's rows for the config (``BASELINE.md``; with the
Hodge MMD for grid_small_CC); exits 1 if a mean misses its bound or was
not measured.  community_small_Base_CC has no such row (its one JAX row
samples a shipped checkpoint the tree does not hold: printed as context,
not a bound); its bar is the JAX trainer at an equal budget on the CPU,
``scripts/jax_equal_budget.py``.  The bound holds
only for a run of the published epochs: a shorter one (``--epochs``, or
``--train-seconds``, which trains in chunks of 500 epochs and stops before
the next chunk, at the last chunk's pace, would end past that many seconds
since the script started) is a cut: one stopped by ``--train-seconds`` is
not scored (it prints the checkpoint to resume), one of fewer ``--epochs``
is scored beside the bounds but not held to them.  ``--eval-at E ...`` also samples and scores the run when it
reaches epoch E (the checkpoint at E is the one a run of E epochs gives:
the learning-rate decay and the EMA do not depend on the total), and
``--resume NAME`` continues the run saved as ``<folder>/checkpoints/<data>/
NAME.pth`` (bit for bit); ``--ckpt NAME`` trains nothing and scores that
checkpoint (a port ``.pth`` or a JAX ``.ckpt.pkl`` under the same
directory, so the port's sampler can score the JAX package's networks).  Each scored run also prints the degree histogram
of its graphs' non-isolated nodes beside the test split's.

    python3 scripts/port_quality_run.py [--config community_small|grid_small|...] \
        [--epochs 5000] [--train-seconds S] [--eval-at 500] [--resume NAME | --ckpt NAME] \
        [--seed 42] [--sample-seeds 12 42 1234] [--folder build/quality_run] \
        [--device cuda] [--matmul-precision highest|high] [--score-dtype f32 [bf16]]

Runs on CUDA (the kernels) unless ``--device cpu`` (the plain path, a
rehearsal at a few epochs: the 1000 steps take about 2 minutes a run
there); ``--matmul-precision high`` lets cuBLAS take TF32 for f32 matmuls
in training and sampling, and every printed ``card`` says so.  Checkpoints and logs go under ``--folder``.
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
import torch  # noqa: E402

from ccsd_tpu_torch.data.loader import generated_adjs, split  # noqa: E402
from ccsd_tpu_torch.sampling.sampler import Sampler, get_sampler_from_config  # noqa: E402
from ccsd_tpu_torch.training.trainer import get_trainer_from_config  # noqa: E402
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
    # grid (N = 361): the only row samples the shipped GDSS checkpoint
    # ("Checkpoint oracle sweep", BASELINE.md:489), which the tree does not
    # hold; no JAX row trains grid from scratch
    "grid": {
        "gdss_checkpoint": {"degree": 0.079, "cluster": 0.011, "orbit": 0.128,
                            "spectral": 0.910},
    },
    # community_small_CC, f32 score networks: its scanned trainer from
    # scratch ("community_small_CC from scratch", BASELINE.md:464-467), the
    # reference's shipped checkpoint ("Quality parity", :43) and the same
    # checkpoint on the fused path (:64-65)
    "community_small_CC": {
        "jax_scanned_trainer": {"degree": 0.151, "cluster": 0.059, "orbit": 0.026,
                                "spectral": 0.227},
        "reference_checkpoint": {"degree": 0.094, "cluster": 0.062, "orbit": 0.025,
                                 "spectral": 0.226},
        "reference_checkpoint_fused": {"degree": 0.095, "cluster": 0.063, "orbit": 0.026,
                                       "spectral": 0.226},
    },
    # the two-stage model trained from scratch, with its Hodge MMD
    # ("Two-stage open-universe model", BASELINE.md:73-80; grid_small_CC's
    # one checkpoint at sampling seeds 12 and 7, :106-117)
    "community_small_CC_two_stage": {
        "jax_two_stage": {"degree": 0.071, "cluster": 0.045, "orbit": 0.026,
                          "spectral": 0.183, "hodge_laplacian_spectrum": 0.091},
    },
    "grid_small_CC_two_stage": {
        "jax_two_stage_seed_12": {"degree": 0.062, "cluster": 0.014, "orbit": 0.017,
                                  "spectral": 0.172, "hodge_laplacian_spectrum": 0.090},
        "jax_two_stage_seed_7": {"degree": 0.015, "cluster": 0.025, "orbit": 0.015,
                                 "spectral": 0.174, "hodge_laplacian_spectrum": 0.109},
    },
    # dense grid_small_CC trained from scratch for 5000 epochs
    # (BASELINE.md:118, 2.86 h on a TPU v5e)
    "grid_small_CC": {
        "jax_dense_from_scratch": {"degree": 0.097, "cluster": 0.172, "orbit": 0.092,
                                   "spectral": 0.211, "hodge_laplacian_spectrum": 0.876},
    },
    "community_small_Base_CC": {},  # no trained-from-scratch row: CONTEXT_ROWS
}
# rows shown beside a run but not held as its bar: community_small_Base_CC's
# one JAX row samples the reference's shipped checkpoint (BASELINE.md:283),
# which the tree does not hold
CONTEXT_ROWS = {
    "community_small_Base_CC": {
        "reference_checkpoint": {"degree": 0.048, "cluster": 0.015, "orbit": 0.023,
                                 "spectral": 0.089, "hodge_laplacian_spectrum": 1.236},
    },
}
GRAPH_MMDS = ("degree", "cluster", "orbit", "spectral")
CC_MMDS = ("hodge_laplacian_spectrum", "rank0_distrib", "rank1_distrib", "rank2_distrib")
BOUND_FACTOR = 1.5
CHUNK_EPOCHS = 500  # --train-seconds trains in chunks of this many epochs
PATHS = {"default": True, "sample.fused: false": False}


def bounds(name: str) -> dict:
    """1.5 times the worst of the config's JAX rows, per MMD they give
    (none where the config has no such row)."""
    rows = list(JAX_ROWS[name].values())
    return {k: BOUND_FACTOR * max(r[k] for r in rows) for k in rows[0]} if rows else {}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip()


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def degree_hist(adjs: np.ndarray) -> list:
    """Share of the non-isolated nodes with each degree 1, 2, ... (index 0
    stays 0: the JAX evaluator drops isolated nodes from generated graphs,
    and no test graph has one)."""
    deg = np.asarray(adjs).sum(-1).astype(np.int64).ravel()
    counts = np.bincount(deg[deg > 0], minlength=2)
    return (counts / max(1, counts.sum())).round(6).tolist()


def score(config, config_name, name, train, test, sample_seeds, device, epochs, published,
          where, bounds, score_dtypes=("f32",)) -> bool:
    """``score_one`` in each of ``score_dtypes``; whether every one passed."""
    ok = True
    for score_dtype in score_dtypes:
        ok &= score_one(config, config_name, name, train, test, sample_seeds, device, epochs,
                        published, where, bounds, score_dtype)
    return ok


def score_one(config, config_name, name, train, test, sample_seeds, device, epochs, published,
              where, bounds, score_dtype) -> bool:
    """Sample the checkpoint ``name`` at each seed on both paths at
    ``sample.score_dtype: score_dtype``, print a line per run, the paths
    compared and a summary per path; returns whether every bounded mean
    was measured and is inside its bound (or the run is a cut).  A
    two-stage run whose F overflowed has its CC MMDs and cells per CC not
    measured."""
    held = epochs is not None and epochs >= published and bool(bounds)
    runs = {p: [] for p in PATHS}
    graphs = {}  # (path, seed) -> the kept adjacencies
    for path, fused in PATHS.items():
        for s in sample_seeds:
            cfg = AttrDict(config.to_dict())
            cfg.ckpt, cfg.sample.seed, cfg.sample.fused = name, s, fused
            cfg.sample.score_dtype = score_dtype
            two_stage = bool(cfg.sample.get("two_stage"))
            if not two_stage:  # scored below, once the output is known to be finite
                cfg.sample.eval = False
            sampler = get_sampler_from_config(cfg, train, test, device=device, log=False)
            res = sampler.sample()
            stages = res.get("finite_stages", {"stage1": res["finite"]})
            if two_stage and not stages["stage1"]:
                raise RuntimeError(f"{path}, seed {s}: non-finite sampler output")
            cells = {k: res[k] for k in ("cells_per_cc", "k_max", "stage1_steps_per_s",
                                         "stage2_steps_per_s", "finite_stages",
                                         "stage2_finite_steps", "stage2_max_abs") if k in res}
            if not two_stage:
                t0 = time.perf_counter()
                if res["finite"]:
                    res.update(sampler.evaluate(test, res["adj"], res.get("ccs")))
                else:
                    # quantize maps NaN to 1, as in the JAX package: the
                    # graphs (and CCs) are not the model's, so not scored
                    res["mmd"], res["cc_mmd"] = dict.fromkeys(GRAPH_MMDS), (
                        dict.fromkeys(CC_MMDS) if config.get("is_cc") else None)
                    if "cells_per_cc" in cells:
                        cells["cells_per_cc"] = None
                res["eval_seconds"] = time.perf_counter() - t0
            if not stages.get("stage2", True):
                # quantize maps an overflowed F's NaN to 1, as in the JAX
                # package: every candidate becomes a cell, so the CC MMDs
                # and cells per CC would score the graphs' own lift
                res["cc_mmd"] = {k: None for k in res["cc_mmd"]}
                cells["cells_per_cc"] = None
            row = {**res["mmd"], **(res["cc_mmd"] or {}),
                   **{k: v for k, v in cells.items() if k not in ("k_max", "finite_stages")}}
            runs[path].append(row)
            graphs[path, s] = res["adj"]
            emit(run="sample", path=path, score_dtype=score_dtype, sample_seed=s, epochs=epochs,
                 weights=res["weights"], graphs=int(res["adj"].shape[0]),
                 mmd=res["mmd"], cc_mmd=res["cc_mmd"], **cells,
                 degree_hist=degree_hist(res["adj"]),
                 steps_per_s=res["steps_per_s"], sampling_seconds=res["sampling_time"],
                 eval_seconds=res["eval_seconds"], card=where)

    # the same seed gives both paths the same flags and noise: count the
    # graphs the fused fast path's bf16 head scores changed
    a, b = PATHS
    emit(run="paths_compared", score_dtype=score_dtype, epochs=epochs, graphs_that_differ={
        s: int((graphs[a, s] != graphs[b, s]).any((1, 2)).sum()) for s in sample_seeds})
    ok = True
    for path, rows in runs.items():
        # an MMD that any seed could not measure has no mean
        vals = {k: [r[k] for r in rows] for k in rows[0]
                if all(r.get(k) is not None for r in rows)}
        mean = {k: float(np.mean(v)) for k, v in vals.items()}
        within = {k: mean[k] <= bounds[k] for k in bounds if k in mean}
        not_measured = sorted(set(rows[0]) - set(vals))
        ok &= (all(within.values()) and len(within) == len(bounds)) or not held
        emit(run="summary", config=config_name, path=path, score_dtype=score_dtype,
             sample_seeds=sample_seeds, mean=mean, min={k: min(v) for k, v in vals.items()},
             max={k: max(v) for k, v in vals.items()}, not_measured=not_measured,
             bounds=bounds, within_bounds=within,
             held_to_bounds=held, epochs=epochs, published_epochs=published)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="community_small", choices=sorted(JAX_ROWS))
    ap.add_argument("--epochs", type=int, default=None, help="default: the config's")
    ap.add_argument("--train-seconds", type=float, default=None,
                    help="train in chunks of 500 epochs within this many seconds")
    ap.add_argument("--eval-at", type=int, nargs="*", default=[],
                    help="also sample and score the run at these epochs")
    ap.add_argument("--resume", default=None, help="continue the run saved as NAME")
    ap.add_argument("--ckpt", default=None, help="score the checkpoint NAME; no training")
    ap.add_argument("--train-seed", type=int, default=None,
                    help="weights, data order and noise of the training (default: --seed)")
    ap.add_argument("--seed", type=int, default=42, help="dataset (and the training, without --train-seed)")
    ap.add_argument("--sample-seeds", type=int, nargs="+", default=[12, 42, 1234])
    ap.add_argument("--folder", default=os.path.join(ROOT, "build", "quality_run"))
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--matmul-precision", default="highest", choices=["highest", "high"],
                    help="high: TF32 in the cuBLAS matmuls on the card (the hand kernels "
                         "stay f32), nearer the TPU's default f32 matmul precision")
    ap.add_argument("--score-dtype", nargs="+", default=["f32"], choices=["f32", "bf16"],
                    help="sample.score_dtype of the scored runs, each in turn (default f32)")
    args = ap.parse_args(argv)
    on_cpu = args.device == "cpu"
    where = "cpu (plain path)" if on_cpu else card()
    torch.set_float32_matmul_precision(args.matmul_precision)
    if args.matmul_precision != "highest":
        where += f", matmul precision {args.matmul_precision}"

    config = AttrDict(get_config(args.config, args.seed, ROOT).to_dict())
    config.folder = args.folder
    if args.train_seed is not None:  # another training of the same dataset
        config.seed = args.train_seed
    published = int(config.train.num_epochs)
    if args.epochs is not None:
        config.train.num_epochs = config.train.save_interval = args.epochs
    BOUNDS = bounds(args.config)
    adjs = generated_adjs(str(config.data.data), args.seed, int(config.data.max_node_num))
    tr, te = split(len(adjs), float(config.data.test_split))
    train, test = adjs[tr], adjs[te]
    emit(run="test_split", graphs=len(test), degree_hist=degree_hist(test))

    if args.ckpt:
        score(config, args.config, args.ckpt, train, test, args.sample_seeds, args.device,
              None, published, where, BOUNDS, args.score_dtype)  # its epochs are not known
        return 0
    trainer = get_trainer_from_config(config, device=args.device, adjs=adjs)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    t0 = time.perf_counter()
    target = int(config.train.num_epochs)
    stops = sorted({e for e in args.eval_at if trainer.epoch < e < target} | {target})
    name = trainer.train() if trainer.epoch >= target else None  # a resume at the end
    for stop in stops:
        chunk = CHUNK_EPOCHS if args.train_seconds else stop
        while trainer.epoch < stop:
            t_chunk = time.perf_counter()
            config.train.num_epochs = min(stop, trainer.epoch + chunk)
            name = trainer.train()
            spent, last = time.perf_counter() - t0, time.perf_counter() - t_chunk
            if args.train_seconds and spent + last > args.train_seconds:
                break
        if trainer.epoch < stop or stop == target:
            break
        emit(run="train", config=args.config, epochs=trainer.epoch, steps=trainer.step,
             seconds=time.perf_counter() - t0, train_steps_per_s=trainer.steps_per_s)
        score(config, args.config, f"{name}_final", train, test, args.sample_seeds,
              args.device, trainer.epoch, published, where, BOUNDS, args.score_dtype)
    if trainer.epoch < target:
        emit(run="train_cut", epochs=trainer.epoch, published_epochs=published,
             train_seconds=args.train_seconds, resume=f"{name}_final",
             ckpt=trainer.checkpoint_path(f"{name}_final"),
             note=f"the next {CHUNK_EPOCHS} epochs would not fit; not scored: resume it")
        return 0
    hist = np.asarray(trainer.history["train"])
    emit(run="train", config=args.config, epochs=trainer.epoch, published_epochs=published,
         steps=trainer.step,
         seconds=time.perf_counter() - t0, train_steps_per_s=trainer.steps_per_s,
         **{f"loss_{n}": [hist[0][i], hist[-1][i]] for i, n in enumerate(trainer.names)},
         ckpt=trainer.checkpoint_path(f"{name}_final"), card=where)
    ok = score(config, args.config, f"{name}_final", train, test, args.sample_seeds,
               args.device, trainer.epoch, published, where, BOUNDS, args.score_dtype)

    floor = Sampler(config, train, test, device=args.device, log=False).evaluate(test, train)
    emit(run="train_vs_test", graphs=[len(train), len(test)], mmd=floor["mmd"],
         cc_mmd=floor["cc_mmd"])
    emit(run="jax_rows", rows=JAX_ROWS[args.config],
         context_rows=CONTEXT_ROWS.get(args.config, {}),
         note="the JAX package's MMDs (BASELINE.md), on a TPU; context rows are not a bar")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
