"""Graph sampler: weights -> PC reverse diffusion -> quantized graphs.

Port of the graph path of ccsd_tpu/sampling/sampler.py:210-375 without the
MMD evaluation.  As in the JAX package (:220-223), the models are built by
``with_fused(defs, sample.fused, fast=sample.fast)``, both on by default:
ScoreNetworkA takes the channel-folded path with bf16 head scores and the
``blocksum`` final layer; ``sample.fused: false`` gives the unfused f32
network, ``sample.fast: false`` the fused one in f32.  Weights come from the
checkpoint the config names (``ckpt``): the port's own ``.pth``
(``training/trainer.py``) where one has that name, else a JAX
``.ckpt.pkl``; without a name, from the port's own seeded initialisation.
``sample.use_ema`` picks the EMA weights of either.  Each round samples ``batch_size`` graphs;
``sample`` runs ``ceil(num_samples / batch_size)`` rounds and returns numpy.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ccsd_tpu_torch import resolve_device
from ccsd_tpu_torch.data.loader import init_flags
from ccsd_tpu_torch.diffusion.losses import get_score_fn
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.diffusion.solvers import get_pc_sampler
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.ops.masks import quantize
from ccsd_tpu_torch.training.checkpoint import (
    ckpt_path,
    load_ckpt_file,
    load_port_ckpt,
    params_from_ckpt,
    port_ckpt_path,
    state_dict_from_ckpt,
)
from ccsd_tpu_torch.utils.config import AttrDict
from ccsd_tpu_torch.utils.from_jax import load_jax_params

NAMES = ("x", "adj")


class Sampler:
    """Graph sampler.

    ``config`` holds the ``sampler`` and ``sample`` sections, plus either
    ``ckpt`` (a port or JAX checkpoint under ``<folder>/checkpoints/<data>/``)
    or the training sections (``data``, ``sde``, ``model``) for a seeded
    init.
    ``train_adjs`` (M, N, N) is the training set the node counts are drawn
    from.  The device defaults to CUDA and raises when there is none.
    """

    def __init__(self, config, train_adjs: np.ndarray, device=None):
        self.config = config
        self.train_adjs = np.asarray(train_adjs, np.float32)
        self.device = resolve_device(device)
        if config.get("is_cc", False):
            raise NotImplementedError("CC sampling is not ported yet")

    def load_models(self):
        """(train config, {name: module on the device}, source of the weights)."""
        cfg = self.config
        name = cfg.get("ckpt")

        def defs_of(defs):  # the fused fast path by default at inference
            return with_fused(defs, bool(cfg.sample.get("fused", True)),
                              fast=bool(cfg.sample.get("fast", True)))

        if name:
            folder, data = cfg.get("folder", "./"), str(cfg.data.data)
            use_ema = bool(cfg.sample.get("use_ema", False))
            path = port_ckpt_path(folder, data, str(name))
            port = os.path.exists(path)
            if port:
                ckpt = load_port_ckpt(path, map_location="cpu")
            else:
                path = ckpt_path(folder, data, str(name))
                ckpt = load_ckpt_file(path)
            configt = AttrDict(ckpt["model_config"])
            defs = defs_of({n: ckpt[f"params_{n}"] for n in NAMES})
            models = {}
            for n in NAMES:
                m = load_model(defs[n])
                if port:
                    m.load_state_dict(state_dict_from_ckpt(ckpt, n, m, use_ema))
                    models[n] = m
                else:
                    models[n] = load_jax_params(m, params_from_ckpt(ckpt, n, use_ema))
            source = f"{path} ({'ema' if use_ema else 'raw'} params)"
        else:
            configt = cfg
            g = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
            defs = defs_of(dict(zip(NAMES, load_model_params(cfg))))
            models = {n: load_model(defs[n], generator=g) for n in NAMES}
            source = f"seeded init (seed {int(cfg.get('seed', 0))})"
        models = {n: m.to(self.device).eval() for n, m in models.items()}
        return configt, models, source

    def sample(self, num_samples: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.config
        configt, models, source = self.load_models()
        batch_size = int(configt.data.batch_size)
        n = batch_size if num_samples is None else int(num_samples)
        n_rounds = max(1, math.ceil(n / batch_size))
        N = int(configt.data.max_node_num)
        sdes = {k: load_sde(configt.sde[k]) for k in NAMES}
        sampling_fn = get_pc_sampler(
            sdes["x"], sdes["adj"],
            (batch_size, N, int(configt.data.max_feat_num)), (batch_size, N, N),
            predictor=cfg.sampler.predictor, corrector=cfg.sampler.corrector,
            snr=cfg.sampler.snr, scale_eps=cfg.sampler.scale_eps,
            n_steps=cfg.sampler.n_steps,
            probability_flow=cfg.sample.probability_flow,
            denoise=cfg.sample.noise_removal, eps=cfg.sample.eps,
        )
        score_fns = [get_score_fn(sdes[k], models[k]) for k in NAMES]

        seed = int(cfg.sample.get("seed", 42))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        rng = np.random.default_rng(seed)
        xs, adjs, flags_all = [], [], []
        finite = True
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            flags = torch.from_numpy(init_flags(self.train_adjs, batch_size, rng))
            out = sampling_fn(*score_fns, flags.to(self.device), gen)
            # quantize maps NaN to 1, so finiteness is read before it
            finite &= bool(out.x.isfinite().all() and out.adj.isfinite().all())
            adjs.append(quantize(out.adj).cpu().numpy())
            xs.append(out.x.cpu().numpy())
            flags_all.append(flags.numpy())
        seconds = time.perf_counter() - t0
        return {
            "adj": np.concatenate(adjs)[:n],
            "x": np.concatenate(xs)[:n],
            "flags": np.concatenate(flags_all)[:n],
            "finite": finite,
            "sampling_time": seconds,
            "steps_per_s": n_rounds * sdes["adj"].N / seconds,
            "weights": source,
            "device": str(self.device),
        }

