"""Sampler of the two-stage open-universe CC model.

Port of ccsd_tpu/sampling/two_stage_sampler.py:43-279, the non-molecule
branch.  Loads a two-stage checkpoint (the graph X and A networks and the
dynamic-universe F network; the port's ``.pth`` of ``TwoStageTrainer`` or
a JAX ``.ckpt.pkl``), and per round: samples (X, A) with the graph PC
sampler on the networks ``with_fused`` gives (the fused fast path by
default, ``sample.fused: false`` the unfused one), bridges each quantized
adjacency to its candidate cells capped at the checkpoint's ``k_max``,
reverse-diffuses F over those columns, and decodes the CCs
(``ccs_from_two_stage``).

The protocol is the JAX one: ``ceil(len(test) / data.batch_size)`` rounds,
capped by ``sample.max_samples`` (or ``sample.n_samples`` in rounds of
``n_samples // sample.divide_batch``, cut to ``n_samples``); every
generated CC is kept, so unlike ``Sampler`` the output is not cut to the
test split's size.  With a test split and ``sample.eval`` on, the CCs'
1-skeletons are scored by the four graph MMDs (``mmd``) and the CCs by
``eval_CC_list`` against the test graphs' lift (``cc_mmd``), where the
dense eval incidence has at most ``sample.cc_eval_max_cells`` columns;
else their rank-2 cell counts (``rank2_counts``).
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ccsd_tpu_torch.data.loader import init_flags
from ccsd_tpu_torch.diffusion.losses import get_score_fn
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.diffusion.solvers import get_pc_sampler
from ccsd_tpu_torch.diffusion.two_stage import (
    ccs_from_two_stage,
    get_rank2_sampler,
    two_stage_sample,
)
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.masks import quantize
from ccsd_tpu_torch.sampling.sampler import Sampler, read_checkpoint
from ccsd_tpu_torch.training.two_stage_trainer import lift_kwargs

# sample.cc_eval_max_cells when absent, as in the JAX two-stage sampler
TWO_STAGE_EVAL_MAX_CELLS = 2_000_000


def protocol_rounds(sample_cfg, batch_size: int, num_test: int):
    """(CCs a round, rounds, CCs kept or None for all) of the JAX two-stage
    protocol (two_stage_sampler.py:83-101)."""
    n_samples = int(sample_cfg.get("n_samples") or 0)
    if n_samples:
        batch = max(1, n_samples // int(sample_cfg.get("divide_batch") or 1))
        return batch, math.ceil(n_samples / batch), n_samples
    n_rounds = max(1, math.ceil(num_test / batch_size))
    max_samples = sample_cfg.get("max_samples")
    if max_samples:
        n_rounds = min(n_rounds, max(1, math.ceil(int(max_samples) / batch_size)))
    return batch_size, n_rounds, None


class TwoStageSampler(Sampler):
    """``Sampler``'s interface (``config``, ``train_adjs`` for the node
    counts, ``test_adjs`` to score against, the device: CUDA by default)
    over a two-stage model."""

    def __init__(self, config, train_adjs: np.ndarray, test_adjs: Optional[np.ndarray] = None,
                 device=None, log: bool = True):
        if not config.get("is_cc"):
            raise ValueError("two-stage sampling needs a CC config (is_cc: true)")
        super().__init__(config, train_adjs, test_adjs, device, log)

    def sample(self, num_samples: Optional[int] = None) -> Dict[str, Any]:
        """Sample by the protocol (``num_samples`` sets ``sample.n_samples``).
        Returns the CCs (``ccs``), the stage-1 graphs as numpy (``adj``
        quantized, ``x``, ``flags``), ``finite`` (and per stage,
        ``finite_stages``: quantize maps NaN to 1, as in the JAX package,
        so an overflowed stage 2 makes every candidate a cell; its margin:
        ``stage2_finite_steps``, the fewest steps any round's F stayed
        finite, and ``stage2_max_abs``, the largest finite |F|), ``k_max``
        of each round,
        each round's quantized F (``rank2_rounds``, uint8 (B, E, K_max))
        and slot validity (``valid_rounds``),
        ``cells_per_cc``, the seconds and steps/s of each stage and of the
        bridge, and with a test split and ``sample.eval`` on, ``mmd``,
        ``cc_mmd`` (or ``rank2_counts``) and ``eval_seconds``."""
        cfg = self.config
        read = read_checkpoint(cfg) if cfg.get("ckpt") else None
        if read is not None and not read[0].get("two_stage"):
            raise ValueError(f"{read[1]} is not a two-stage checkpoint")
        configt, models, source = self.load_models(read)
        k_max = read[0].get("k_max") if read is not None else configt.train.get("k_max")
        d = configt.data
        N, d_min, d_max = int(d.max_node_num), int(d.d_min), int(d.d_max)
        spec = get_spec(N, d_min, d_max)
        sample_cfg = dict(cfg.sample, n_samples=num_samples or cfg.sample.get("n_samples"))
        test = self.test_adjs
        batch_size, n_rounds, keep = protocol_rounds(
            sample_cfg, int(d.batch_size), 1 if test is None else len(test))

        sdes = {k: load_sde(configt.sde[k]) for k in self.names}
        sm = cfg.sampler
        kw = dict(predictor=sm.predictor, corrector=sm.corrector, snr=sm.snr,
                  scale_eps=sm.scale_eps, n_steps=sm.n_steps,
                  probability_flow=cfg.sample.probability_flow,
                  denoise=cfg.sample.noise_removal, eps=cfg.sample.eps)
        graph_sampler = get_pc_sampler(sdes["x"], sdes["adj"],
                                       (batch_size, N, int(d.max_feat_num)),
                                       (batch_size, N, N), **kw)
        rank2_sampler = get_rank2_sampler(sdes["rank2"], spec, **kw)
        sfx, sfa = (get_score_fn(sdes[k], models[k]) for k in ("x", "adj"))
        bridge_kw = lift_kwargs(d)

        seed = int(cfg.sample.get("seed", 42))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        rng = np.random.default_rng(seed)
        ccs: List = []
        xs, adjs, flags_all, k_maxes, rank2s, valids = [], [], [], [], [], []
        finite = {"stage1": True, "stage2": True}
        seconds = {"stage1": 0.0, "bridge": 0.0, "stage2": 0.0}
        margins = []  # each round's stage-2 steps while finite and largest |F|
        for _ in range(n_rounds):
            flags = torch.from_numpy(init_flags(self.train_adjs, batch_size, rng))
            margins.append({})
            out, adj_q, rank2, dyn, secs = two_stage_sample(
                graph_sampler, sfx, sfa, rank2_sampler, models["rank2"], sdes["rank2"], spec,
                flags.to(self.device), gen, d_min, d_max, k_max, stats=margins[-1], **bridge_kw)
            finite["stage1"] &= bool(out.x.isfinite().all()) and bool(out.adj.isfinite().all())
            finite["stage2"] &= bool(rank2.isfinite().all())
            for k, v in secs.items():
                seconds[k] += v
            x, adj_q = out.x.cpu().numpy(), adj_q.cpu().numpy()
            rank2_q = quantize(rank2).to(torch.uint8).cpu().numpy()
            ccs.extend(ccs_from_two_stage(x, adj_q, rank2_q, dyn, spec))
            xs.append(x)
            adjs.append(adj_q)
            flags_all.append(flags.numpy())
            k_maxes.append(dyn.k_max)
            rank2s.append(rank2_q)
            valids.append(dyn.valid.numpy())
        ccs = ccs[:keep]
        results: Dict[str, Any] = {
            "ccs": ccs,
            "adj": np.concatenate(adjs)[:keep],
            "x": np.concatenate(xs)[:keep],
            "flags": np.concatenate(flags_all)[:keep],
            "finite": all(finite.values()),
            "finite_stages": finite,
            "stage2_finite_steps": min(m["finite_steps"] for m in margins),
            "stage2_max_abs": max(m["max_abs"] for m in margins),
            "k_max": k_maxes,
            "rank2_rounds": rank2s,
            "valid_rounds": valids,
            "cells_per_cc": float(np.mean([len(c.cells.hyperedge_dict.get(2, {}))
                                           for c in ccs])),
            "sampling_time": sum(seconds.values()),
            "stage_seconds": seconds,
            "stage1_steps_per_s": n_rounds * sdes["adj"].N / seconds["stage1"],
            "stage2_steps_per_s": n_rounds * sdes["rank2"].N / seconds["stage2"],
            "weights": source,
            "device": str(self.device),
        }
        results["steps_per_s"] = n_rounds * sdes["adj"].N / results["sampling_time"]
        if test is not None and cfg.sample.get("eval", True):
            t0 = time.perf_counter()
            results.update(self.evaluate_ccs(test, ccs, spec))
            results["eval_seconds"] = time.perf_counter() - t0
        self.save_samples(results)
        return results

    def evaluate_ccs(self, test_adjs: np.ndarray, ccs: list, spec) -> Dict[str, Any]:
        """``mmd`` and ``cc_mmd`` of the generated CCs against the test
        graphs' lift, or with an intractable dense incidence, ``mmd`` and
        the rank-2 cell counts (two_stage_sampler.py:215-277)."""
        limit = int(self.config.sample.get("cc_eval_max_cells", TWO_STAGE_EVAL_MAX_CELLS))
        if spec.num_cells <= limit:
            return self.evaluate(test_adjs, None, ccs)

        def counts(cs):
            return [len(c.cells.hyperedge_dict.get(2, {})) for c in cs]

        out = self.evaluate(test_adjs, None, ccs, cc_eval=False)
        g, t = counts(ccs), counts(self.lift(test_adjs))
        out["rank2_counts"] = {
            "gen_mean": float(np.mean(g)), "gen_std": float(np.std(g)),
            "test_mean": float(np.mean(t)), "test_std": float(np.std(t)),
            "note": f"dense CC-MMD skipped: spec.num_cells={spec.num_cells} exceeds "
                    "cc_eval_max_cells"}
        return out
