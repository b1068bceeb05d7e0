"""Joint training of the score networks: ScoreNetworkX and ScoreNetworkA
in graph mode, ScoreNetworkX, ScoreNetworkA_CC (or ScoreNetworkA_Base_CC)
and ScoreNetworkF in CC mode.

Port of ccsd_tpu/training/trainer.py:55-455 on one device, without the
mesh, ``train_scanned``, ``remat``, ``profile_dir``, the wandb tracker and
the learning-curve plot; ``get_trainer_from_config`` hands a
``train.two_stage`` config to ``training/two_stage_trainer.py``.  Per batch: every network's
DSM loss, one backward of their sum (each loss reaches only its own
network), then per network the optimizer
(``training/optim.py``) and the EMA (``training/ema.py``).  Per epoch: the
test loss under the EMA weights, without gradients.  Every
``print_interval`` epochs (and the first) a log line; every
``save_interval`` epochs a checkpoint ``<name>``, and ``<name>_final`` at
the end (``training/checkpoint.py``), from which ``load_checkpoint``
resumes the run exactly where it stopped.

On the card the networks run the CUDA kernels forward and backward
(``gcn_aggregate`` and ``gmh_attention``, with their backward kernels):
training takes the unfused networks unless ``model.fused`` is set, and the
fused kernels have no backward yet, so a ``model.fused`` config raises
there.  The seed drives the data order (``ArrayDataset``, as the JAX
package shuffles), the networks' seeded Glorot init, and a generator on
the device that draws t and the noise.  The dataset is a (M, N, N) array of
padded adjacencies: community_small's, grid_small's or grid's generated by
its recipe from the seed (100 graphs) unless the caller passes one; in CC
mode with the rank-2 incidences of its lift, in uint8.  Each split is
copied to the device once (``ArrayDataset``), and each batch gathered
there and cast to f32: grid_small_CC's 80 training incidences of 1176 ×
18,424 take 1.73 GB so.  Above 64 nodes (grid: 361) the backward kernels
take their row-tile designs.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional

import numpy as np
import torch

from ccsd_tpu_torch import resolve_device
from ccsd_tpu_torch.data.loader import (
    GENERATED,
    ArrayDataset,
    generated_adjs,
    init_features,
    lifted_rank2,
    split,
)
from ccsd_tpu_torch.diffusion.losses import SDELossCC, get_sde_loss_fn
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.models.registry import load_model, load_model_params
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.training.checkpoint import load_port_ckpt, port_ckpt_path, save_port_ckpt
from ccsd_tpu_torch.training.ema import EMA
from ccsd_tpu_torch.training.optim import Optimizer
from ccsd_tpu_torch.utils.logger import Logger, set_log

NAMES = ("x", "adj")
NAMES_CC = ("x", "adj", "rank2")


def dataset_adjs(config, adjs: Optional[np.ndarray] = None) -> np.ndarray:
    """The (M, N, N) training set: ``adjs`` as given, or the dataset's
    recipe (community_small, grid_small, grid) run from the config's
    seed."""
    if adjs is not None:
        return np.asarray(adjs, np.float32)
    data = str(config.data.data)
    if data not in GENERATED:
        raise ValueError(f"{data}: pass the dataset as a (M, N, N) array (only "
                         f"{', '.join(GENERATED)} are generated here)")
    return generated_adjs(data, int(config.get("seed", 42)), int(config.data.max_node_num))


class Trainer:
    """Trainer of the score networks on one device (CUDA unless ``device``
    says otherwise)."""

    def __init__(self, config, device=None, adjs: Optional[np.ndarray] = None,
                 log: bool = True):
        self.config = config
        self.is_cc = bool(config.get("is_cc", False))
        self.names = names = NAMES_CC if self.is_cc else NAMES
        self.device = resolve_device(device)
        self.seed = int(config.get("seed", 42))
        tc = config.train

        self.log_folder_name, self.log_name, self.ckpt_name = (
            set_log(config) if log else ("", "train", "ckpt"))
        log_path = None
        if log:
            log_path = f"{self.log_folder_name}/{self.log_name}.log"
        self.logger = Logger(file_path=log_path, verbose=True)

        # data: features, split and batch order as the JAX package makes them
        a = dataset_adjs(config, adjs)
        x = init_features(config.data.init, a, int(config.data.max_feat_num))
        arrays = (x, a.astype(np.float32)) + (
            (lifted_rank2(a, config.data, np.uint8),) if self.is_cc else ())
        tr, te = split(len(a), float(config.data.test_split))
        bs = int(config.data.batch_size)
        self.train_loader, self.test_loader = (
            ArrayDataset([v[s] for v in arrays], bs, seed=self.seed, device=self.device)
            for s in (tr, te))

        # networks, their EMA copies for evaluation, optimizers, EMAs
        self.model_param_defs = dict(zip(names, load_model_params(config)))
        g = torch.Generator().manual_seed(self.seed)
        self.models = {n: load_model(self.model_param_defs[n], generator=g).to(self.device)
                       for n in names}
        self.eval_models = {n: copy.deepcopy(m).eval() for n, m in self.models.items()}
        for m in self.eval_models.values():
            m.requires_grad_(False)
        self.sdes = {n: load_sde(config.sde[n]) for n in names}
        if self.is_cc:
            d = config.data
            self.loss_fn = SDELossCC(*self.sdes.values(),
                                     get_spec(int(d.max_node_num), int(d.d_min),
                                              int(d.d_max)),
                                     reduce_mean=tc.reduce_mean, eps=tc.eps)
        else:
            self.loss_fn = get_sde_loss_fn(self.sdes["x"], self.sdes["adj"],
                                           reduce_mean=tc.reduce_mean, eps=tc.eps)
        self.optimizers = {
            n: Optimizer(self.models[n].parameters(), lr=tc.lr,
                         weight_decay=tc.weight_decay, grad_norm=tc.grad_norm,
                         lr_schedule=tc.lr_schedule, lr_decay=tc.lr_decay,
                         steps_per_epoch=len(self.train_loader))
            for n in names}
        self.emas = {n: EMA(self.models[n], tc.ema) for n in names}
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.epoch = 0
        self.step = 0
        self.history: Dict[str, list] = {"train": [], "test": []}
        self.steps_per_s = float("nan")
        if log:
            d = config.data
            self.logger.log(f"[{d.data}] init={d.init} ({d.max_feat_num}) seed={self.seed} "
                            f"batch_size={d.batch_size} device={self.device} "
                            f"train/test graphs={len(x[tr])}/{len(x[te])}")

    def train_step(self, *batch: torch.Tensor) -> torch.Tensor:
        """One update of every network from a (x, adj[, rank2]) batch;
        returns the losses' tensor, in ``names`` order, left on the device."""
        for opt in self.optimizers.values():
            opt.zero_grad()
        losses = self.loss_fn(*self.models.values(), *batch, self.generator)
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss
        total.backward()
        for n in self.names:
            self.optimizers[n].step()
            self.emas[n].update(self.models[n])
        self.step += 1
        return torch.stack(losses).detach()

    @torch.no_grad()
    def eval_step(self, *batch: torch.Tensor) -> torch.Tensor:
        """The test losses under the EMA weights."""
        return torch.stack(self.loss_fn(*self.eval_models.values(), *batch, self.generator))

    def train(self) -> str:
        """Train from ``self.epoch`` to ``train.num_epochs``; returns the
        checkpoint name."""
        tc = self.config.train
        t_start = time.perf_counter()
        first = self.epoch
        for epoch in range(first, int(tc.num_epochs)):
            t0 = time.perf_counter()
            for m in self.models.values():
                m.train()
            train_losses = [self.train_step(*b) for b in self.train_loader]
            for n in self.names:
                self.emas[n].copy_to(self.eval_models[n])
            test_losses = [self.eval_step(*b) for b in self.test_loader]
            mean_train = torch.stack(train_losses).mean(0).tolist()
            mean_test = torch.stack(test_losses).mean(0).tolist()
            self.history["train"].append(mean_train)
            self.history["test"].append(mean_test)
            self.epoch = epoch + 1

            if epoch % tc.print_interval == tc.print_interval - 1 or epoch == 0:
                parts_te = " | ".join(f"test {n}: {v:.3e}" for n, v in zip(self.names, mean_test))
                parts_tr = " | ".join(f"train {n}: {v:.3e}" for n, v in zip(self.names, mean_train))
                self.logger.log(f"[EPOCH {epoch + 1:04d}] {parts_te} | {parts_tr} | "
                                f"{time.perf_counter() - t0:.2f}s")
            if epoch % tc.save_interval == tc.save_interval - 1:
                self.save_checkpoint(suffix="")
        seconds = time.perf_counter() - t_start
        steps = (self.epoch - first) * len(self.train_loader)
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
                   "epoch": self.epoch, "step": self.step, "history": self.history,
                   "rng": {"train_order": self.train_loader.rng.bit_generator.state,
                           "test_order": self.test_loader.rng.bit_generator.state,
                           "noise": self.generator.get_state()}}
        for n in self.names:
            payload[f"params_{n}"] = dict(self.model_param_defs[n])
            payload[f"{n}_state_dict"] = self.models[n].state_dict()
            payload[f"ema_{n}"] = self.emas[n].state_dict()
            payload[f"{n}_opt_state"] = self.optimizers[n].state_dict()
        return save_port_ckpt(self.checkpoint_path(f"{self.ckpt_name}{suffix}"), payload)

    def load_checkpoint(self, name: str) -> None:
        """Resume from the port checkpoint ``name``: parameters, optimizer
        and EMA states, epoch, step, history and the generators' states."""
        path = self.checkpoint_path(name)
        # loaded to the host: each state's load moves it to its parameters'
        # device, and Adam keeps its step counts on the host, as a fresh run
        # does (a step count on the card would cost a sync a parameter)
        ckpt = load_port_ckpt(path, map_location="cpu")
        for n in self.names:
            self.models[n].load_state_dict(ckpt[f"{n}_state_dict"])
            self.optimizers[n].load_state_dict(ckpt[f"{n}_opt_state"])
            self.emas[n].load_state_dict(ckpt[f"ema_{n}"])
        self.epoch, self.step = int(ckpt["epoch"]), int(ckpt["step"])
        self.history = {k: [list(v) for v in h] for k, h in ckpt["history"].items()}
        rng = ckpt["rng"]
        self.train_loader.rng.bit_generator.state = rng["train_order"]
        self.test_loader.rng.bit_generator.state = rng["test_order"]
        self.generator.set_state(rng["noise"])
        self.logger.log(f"Resumed training state from {path} (epoch {self.epoch})")


def get_trainer_from_config(config, **kwargs):
    """``TwoStageTrainer`` where ``train.two_stage`` is set, else
    ``Trainer`` (ccsd_tpu/training/trainer.py:448-455)."""
    if config.train.get("two_stage"):
        from ccsd_tpu_torch.training.two_stage_trainer import TwoStageTrainer

        return TwoStageTrainer(config, **kwargs)
    return Trainer(config, **kwargs)
