"""Training of the two-stage open-universe CC model, p(X, A) · p(F | A).

Port of ccsd_tpu/training/two_stage_trainer.py:43-230 on one device, the
non-molecule branch.  ScoreNetworkX and the graph ScoreNetworkA train on
the graph DSM loss of (x, adj); ScoreNetworkF trains on the DSM loss of F
over each training CC's candidate cells, listed from its own adjacency by
the bridge the sampler uses (``diffusion/two_stage.py``).  Each epoch is
one step on the full training batch (the 80 training CCs of
community_small_CC), with no test loss; per network its optimizer and EMA.
The graph loss and the F loss draw from separate generators on the device.

The dataset is the config's graphs (generated from the seed, or the
caller's ``adjs``) lifted by ``data.lifting_procedure`` and split as the
JAX trainer splits its CC list; the node features are
``init_features(data.init)`` of the CCs' adjacencies.  The checkpoint is
the port's ``.pth`` (``training/checkpoint.py``) plus ``two_stage: True``
and ``k_max``, the slot budget of the training batch, which the sampler
caps its candidates at.  A CC adjacency model is refused, and so is
``train.minibatch`` (not ported).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ccsd_tpu_torch import resolve_device
from ccsd_tpu_torch.data.cc_codec import convert_graphs_to_CCs
from ccsd_tpu_torch.data.loader import init_features, split
from ccsd_tpu_torch.diffusion.losses import get_rank2_dynamic_loss_fn, get_sde_loss_fn
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.diffusion.two_stage import dynamic_batch_from_ccs
from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
from ccsd_tpu_torch.models.registry import load_model, load_model_params
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.masks import node_flags
from ccsd_tpu_torch.training.checkpoint import load_port_ckpt, port_ckpt_path, save_port_ckpt
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.optim import Optimizer
from ccsd_tpu_torch.training.trainer import dataset_adjs
from ccsd_tpu_torch.utils.logger import Logger, set_log

NAMES = ("x", "adj", "rank2")


def lift_kwargs(data) -> dict:
    """The bridge's arguments for the config's lift: path_based takes
    paths of ``data.path_length`` nodes (default d_max)."""
    lift = data.get("lifting_procedure", "cycles")
    kw = {"lifting_procedure": lift}
    if lift == "path_based":
        kw["path_length"] = int(data.get("path_length", data.d_max))
    return kw


def lifted_ccs(adjs: np.ndarray, data) -> list:
    """The CCs of the graphs ``adjs`` lifted by the config's lift, as the
    JAX package builds its CC datasets (generators.py:244-255)."""
    return convert_graphs_to_CCs(adjs_to_graphs(adjs),
                                 lifting_procedure=data.get("lifting_procedure"),
                                 lifting_procedure_kwargs=data.get("lifting_procedure_kwargs"))


class TwoStageTrainer:
    """Trainer of the graph X and A networks and the dynamic-universe F
    network on one device (CUDA unless ``device`` says otherwise)."""

    def __init__(self, config, device=None, adjs: Optional[np.ndarray] = None,
                 log: bool = True):
        if not config.get("is_cc"):
            raise ValueError("two-stage training needs a CC config (is_cc: true)")
        if "CC" in str(config.model.adj):
            raise ValueError("two-stage: model.adj must be a graph model (e.g. ScoreNetworkA); "
                             f"got {config.model.adj}")
        if config.train.get("minibatch"):
            raise NotImplementedError("train.minibatch of the two-stage trainer is not ported "
                                      "(ROADMAP.md, Queue A, training extras)")
        self.config = config
        self.names = NAMES
        self.device = resolve_device(device)
        d, tc = config.data, config.train
        N = int(d.max_node_num)
        self.seed = int(config.get("seed", 42))
        self.log_folder_name, self.log_name, self.ckpt_name = (
            set_log(config) if log else ("", "train", "ckpt"))
        log_path = f"{self.log_folder_name}/{self.log_name}.log" if log else None
        self.logger = Logger(file_path=log_path, verbose=log)

        # data: the lifted CCs, split as the JAX trainer splits them, and
        # the training batch of the bridge
        ccs = lifted_ccs(dataset_adjs(config, adjs), d)
        tr, te = split(len(ccs), float(d.test_split))
        self.train_ccs, self.test_ccs = ccs[tr], ccs[te]
        self.spec = get_spec(N, int(d.d_min), int(d.d_max))
        k_max = tc.get("k_max")
        adj, rank2, dyn = dynamic_batch_from_ccs(self.train_ccs, self.spec, int(d.d_min),
                                                 int(d.d_max), k_max, **lift_kwargs(d))
        self.k_max = dyn.k_max
        x = torch.from_numpy(init_features(d.init, adj.numpy(), int(d.max_feat_num)))
        self.batch = tuple(t.to(self.device) for t in (x, adj, rank2, dyn.member, dyn.valid))

        self.model_param_defs = dict(zip(NAMES, load_model_params(config, is_cc=True)))
        g = torch.Generator().manual_seed(self.seed)
        self.models = {n: load_model(self.model_param_defs[n], generator=g).to(self.device)
                       for n in NAMES}
        self.sdes = {n: load_sde(config.sde[n]) for n in NAMES}
        self.loss_graph = get_sde_loss_fn(self.sdes["x"], self.sdes["adj"],
                                          reduce_mean=tc.reduce_mean, eps=tc.eps)
        self.loss_rank2 = get_rank2_dynamic_loss_fn(self.sdes["rank2"], self.spec,
                                                    reduce_mean=tc.reduce_mean, eps=tc.eps)
        self.optimizers = {
            n: Optimizer(self.models[n].parameters(), lr=tc.lr, weight_decay=tc.weight_decay,
                         grad_norm=tc.grad_norm, lr_schedule=tc.lr_schedule,
                         lr_decay=tc.lr_decay)
            for n in NAMES}
        self.emas = {n: EMA(self.models[n], tc.ema) for n in NAMES}
        self.generators = {
            "graph": torch.Generator(device=self.device).manual_seed(self.seed),
            "rank2": torch.Generator(device=self.device).manual_seed(self.seed + 1)}
        self.epoch = 0
        self.step = 0
        self.history: Dict[str, list] = {"train": []}
        self.steps_per_s = float("nan")
        if log:
            self.logger.log(f"[{d.data}] two-stage init={d.init} ({d.max_feat_num}) "
                            f"seed={self.seed} device={self.device} train/test CCs="
                            f"{len(self.train_ccs)}/{len(self.test_ccs)} k_max={self.k_max}")

    def train_step(self) -> torch.Tensor:
        """One update of the three networks on the full training batch;
        returns (loss_x, loss_adj, loss_rank2), left on the device."""
        x, adj, rank2, member, valid = self.batch
        for opt in self.optimizers.values():
            opt.zero_grad()
        m = self.models
        lx, la = self.loss_graph(m["x"], m["adj"], x, adj, self.generators["graph"])
        lf = self.loss_rank2(m["rank2"], rank2, node_flags(adj), member, valid,
                             self.generators["rank2"])
        (lx + la + lf).backward()
        for n in NAMES:
            self.optimizers[n].step()
            self.emas[n].update(self.models[n])
        self.step += 1
        return torch.stack([lx, la, lf]).detach()

    def train(self) -> str:
        """Train from ``self.epoch`` to ``train.num_epochs``; returns the
        checkpoint name."""
        tc = self.config.train
        t_start = time.perf_counter()
        first = self.epoch
        for m in self.models.values():
            m.train()
        for epoch in range(first, int(tc.num_epochs)):
            losses = self.train_step().tolist()
            self.history["train"].append(losses)
            self.epoch = epoch + 1
            if epoch % tc.print_interval == tc.print_interval - 1 or epoch == 0:
                lx, la, lf = losses
                self.logger.log(f"[TWO-STAGE {epoch + 1:04d}] x {lx:.3e} | adj {la:.3e} | "
                                f"F {lf:.3e} | {time.perf_counter() - t_start:.1f}s")
            if epoch % tc.save_interval == tc.save_interval - 1:
                self.save_checkpoint(suffix="")
        seconds = time.perf_counter() - t_start
        steps = self.epoch - first
        self.steps_per_s = steps / seconds if steps else float("nan")
        self.save_checkpoint(suffix="_final")
        self.logger.log(f"Training done in {seconds:.1f}s ({self.step} steps, "
                        f"{self.steps_per_s:.2f} steps/s)")
        return self.ckpt_name

    # ------------------------------------------------------------ checkpoint --

    def checkpoint_path(self, name: str) -> str:
        cfg = self.config
        return port_ckpt_path(cfg.get("folder", "./"), str(cfg.data.data), name)

    def save_checkpoint(self, suffix: str = "") -> str:
        cfg = self.config
        payload = {"model_config": cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg),
                   "two_stage": True, "k_max": self.k_max,
                   "epoch": self.epoch, "step": self.step, "history": self.history,
                   "rng": {k: g.get_state() for k, g in self.generators.items()}}
        for n in NAMES:
            payload[f"params_{n}"] = dict(self.model_param_defs[n])
            payload[f"{n}_state_dict"] = self.models[n].state_dict()
            payload[f"ema_{n}"] = self.emas[n].state_dict()
            payload[f"{n}_opt_state"] = self.optimizers[n].state_dict()
        return save_port_ckpt(self.checkpoint_path(f"{self.ckpt_name}{suffix}"), payload)

    def load_checkpoint(self, name: str) -> None:
        """Resume from the port checkpoint ``name``: parameters, optimizer
        and EMA states, epoch, step, history and the generators' states."""
        path = self.checkpoint_path(name)
        ckpt = load_port_ckpt(path, map_location="cpu")
        if not ckpt.get("two_stage") or ckpt["k_max"] != self.k_max:
            raise ValueError(f"{path} is not a two-stage checkpoint of this batch "
                             f"(k_max {ckpt.get('k_max')}, here {self.k_max})")
        for n in NAMES:
            self.models[n].load_state_dict(ckpt[f"{n}_state_dict"])
            self.optimizers[n].load_state_dict(ckpt[f"{n}_opt_state"])
            self.emas[n].load_state_dict(ckpt[f"ema_{n}"])
        self.epoch, self.step = int(ckpt["epoch"]), int(ckpt["step"])
        self.history = {k: [list(v) for v in h] for k, h in ckpt["history"].items()}
        for k, g in self.generators.items():
            g.set_state(ckpt["rng"][k])
        self.logger.log(f"Resumed training state from {path} (epoch {self.epoch})")
