"""The JAX package's side of an equal-budget comparison with the port, on
the CPU: train a graph config from scratch with ``Trainer.train_scanned``
(as the JAX package's own from-scratch rows were trained) for a cut number
of epochs, then sample the final checkpoint by the config's protocol at
each sampling seed and print the four graph MMDs and the degree histogram
of the kept graphs beside the test split's (a CC config: its lifted
dataset, the CC MMDs too, at f32 score networks unless ``--score-dtype
bf16`` asks for the JAX package's bf16 ones).

    JAX_PLATFORMS=cpu python3 scripts/jax_equal_budget.py --config grid_small \
        --epochs 500 [--seed 42] [--sample-seeds 12 42 1234] [--folder build/jax_budget] \
        [--ckpt PATH] [--score-dtype f32|bf16]

``--ckpt PATH`` skips the training and samples that checkpoint instead: a
JAX ``.ckpt.pkl`` or a port ``.pth`` (the JAX sampler converts the port's
reference-layout weights), so the JAX sampler can score the port's trained
networks.

The dataset is the JAX package's own recipe run after ``np.random.seed(seed)``
(``ccsd_tpu.data.generators.generate_dataset``), written under the folder:
the same graphs as the port's ``generated_adjs(config, seed)``.  Prints one
JSON line per sampling seed and a summary line (mean, min, max of each MMD).
The port's side is ``scripts/port_quality_run.py --eval-at``.  This script
imports the JAX package and runs only where it is installed; the port never
imports it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="grid_small")
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--train-seed", type=int, default=None,
                    help="weights, data order and noise of the training (default: --seed)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--sample-seeds", type=int, nargs="+", default=[12, 42, 1234])
    ap.add_argument("--folder", default=os.path.join(ROOT, "build", "jax_budget"))
    ap.add_argument("--ckpt", default=None, help="sample this checkpoint; no training")
    ap.add_argument("--score-dtype", default="f32", choices=["f32", "bf16"],
                    help="sample.score_dtype of the sampling runs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from ccsd_tpu.data.generators import generate_dataset
    from ccsd_tpu.sampling.sampler import get_sampler_from_config
    from ccsd_tpu.training.trainer import get_trainer_from_config
    from ccsd_tpu.utils.config import get_config

    folder = os.path.abspath(args.folder)
    data_dir = os.path.join(folder, "data")
    cfg = get_config(args.config, seed=args.seed, folder=ROOT)
    np.random.seed(args.seed)
    is_cc = bool(cfg.get("is_cc", False))
    data = str(cfg.data.data)
    generate_dataset(data[: -len("_CC")] if is_cc else data, data_dir=data_dir, is_cc=is_cc)
    cfg.folder, cfg.data.dir = folder, data_dir
    cfg.train.num_epochs = cfg.train.save_interval = args.epochs
    if args.train_seed is not None:  # another training of the same dataset
        cfg.seed = args.train_seed

    t0 = time.perf_counter()
    if args.ckpt:
        import shutil

        base = os.path.basename(args.ckpt)
        ext = ".ckpt.pkl" if base.endswith(".ckpt.pkl") else ".pth"
        dest = os.path.join(folder, "checkpoints", str(cfg.data.data))
        os.makedirs(dest, exist_ok=True)
        shutil.copyfile(args.ckpt, os.path.join(dest, base))
        name = base[: -len(ext)]
        name = name[: -len("_final")] if name.endswith("_final") else name
        print(json.dumps({"run": "checkpoint", "path": args.ckpt}), flush=True)
    else:
        name = get_trainer_from_config(cfg).train_scanned(epochs_per_call=args.epochs)
        print(json.dumps({"run": "train", "config": args.config, "epochs": args.epochs,
                          "seconds": time.perf_counter() - t0, "device": "cpu"}), flush=True)

    rows = []
    for s in args.sample_seeds:
        scfg = get_config(args.config, seed=args.seed, folder=ROOT)
        scfg.folder, scfg.data.dir = folder, data_dir
        scfg.ckpt, scfg.sample.seed = f"{name}_final", s
        scfg.sample.score_dtype = args.score_dtype
        t0 = time.perf_counter()
        try:
            res = get_sampler_from_config(scfg).sample()
        except (KeyError, ValueError) as e:
            # the JAX sampler quantizes NaN to 1, and its CC scoring then
            # fails on the cells it decodes: the seed is reported, not scored
            print(json.dumps({"run": "sample", "sample_seed": s, "error": repr(e),
                              "seconds": time.perf_counter() - t0}), flush=True)
            continue
        rows.append(res["mmd"])
        print(json.dumps({
            "run": "sample", "sample_seed": s, "score_dtype": args.score_dtype,
            "graphs": len(res["graphs"]),
            "mmd": res["mmd"], "cc_mmd": res.get("cc_mmd"),
            "degree_hist": _hist_graphs(res["graphs"]),
            "seconds": time.perf_counter() - t0}), flush=True)
    from ccsd_tpu.data.loader import load_data

    _, test = load_data(cfg, get_list=True, is_cc=is_cc)
    if is_cc:
        from ccsd_tpu.data.cc_codec import convert_CC_to_graphs

        test = convert_CC_to_graphs(test)
    keys = list(rows[0]) if rows else []
    print(json.dumps({
        "run": "summary", "config": args.config, "epochs": None if args.ckpt else args.epochs,
        "score_dtype": args.score_dtype,
        "sample_seeds": args.sample_seeds, "scored_seeds": len(rows),
        "mean": {k: float(np.mean([r[k] for r in rows])) for k in keys},
        "min": {k: float(min(r[k] for r in rows)) for k in keys},
        "max": {k: float(max(r[k] for r in rows)) for k in keys},
        "test_degree_hist": _hist_graphs(test)}), flush=True)
    return 0


def _hist_graphs(graphs) -> list:
    """Share of the nodes with each degree 0, 1, ... (the evaluator drops
    isolated nodes from generated graphs)."""
    counts = np.bincount([d for g in graphs for _, d in g.degree()], minlength=2)
    return (counts / max(1, counts.sum())).round(6).tolist()


if __name__ == "__main__":
    sys.exit(main())
