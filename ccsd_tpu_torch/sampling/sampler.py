"""Graph and CC sampler: weights -> PC reverse diffusion -> quantized
graphs (and rank-2 incidences) -> MMD.

Port of ccsd_tpu/sampling/sampler.py:49-93 (``load_sampling_fn``: the PC
sampler, or the S4 solver for ``sampler.predictor: S4``) and :210-433,
graph and dense CC mode, without the trajectory figures and the mesh;
``get_sampler_from_config`` hands a ``sample.two_stage`` config to
``sampling/two_stage_sampler.py``.  As in the JAX package (:220-223), the models are
built by ``with_fused(defs, sample.fused, fast=sample.fast)``, both on by
default: ScoreNetworkA takes the channel-folded path with bf16 head scores
and the ``blocksum`` final layer; ``sample.fused: false`` gives the unfused
f32 network, ``sample.fast: false`` the fused one in f32.  Weights come
from the checkpoint the config names (``ckpt``): the port's own ``.pth``
(``training/trainer.py``) where one has that name, else a JAX
``.ckpt.pkl``; without a name, from the port's own seeded initialisation.
``sample.use_ema`` picks the EMA weights of either.

The evaluation protocol is the JAX sampler's (:243-258, :340-433): rounds
of ``data.batch_size // sample.divide_batch`` graphs, ``ceil(len(test) /
batch)`` of them, capped by ``sample.max_samples``; the first ``len(test)``
graphs are kept, and with ``sample.eval`` on (the default) scored against
the test split: the four graph MMDs (``mmd``) and, where
``data.lifting_procedure`` is set and the dense CC incidence is tractable
(``cc_eval_tractable``), the four lifted-CC MMDs (``cc_mmd``).  The kept
graphs go to ``<folder>/samples/<data>/samples.npz`` (adjacency, x,
flags), the port's counterpart of the JAX sampler's ``samples.pkl`` of
networkx graphs.

In CC mode (``is_cc``: ScoreNetworkX, ScoreNetworkA_CC or the ablation
network ScoreNetworkA_Base_CC, and ScoreNetworkF) the reverse diffusion
also carries the rank-2 incidence; each kept sample's quantized (x,
adjacency, rank-2) becomes a CC (``cc_from_incidence``), its
1-skeleton graph (``convert_CC_to_graphs``) is scored by the graph MMDs
against the test split's, and the CCs by ``eval_CC_list`` against the test
graphs lifted by the config's ``data.lifting_procedure`` (``cc_mmd``);
``samples.npz`` adds the rank-2 incidences (uint8).

Two bf16 modes, as in the JAX package.  ``sample.score_dtype`` (selective
precision: the score networks on bf16 copies of their parameters and
inputs, f32 scores, carry and noise; ``diffusion/losses.py``) resolves as
the JAX sampler resolves it (:103-113, :300-312): bf16 by default for the
CC datasets it cleared (community_small_CC, ego_small_CC), else f32; an
explicit value wins.  ``sample.dtype: bf16`` (:65-77) is the bf16 reverse
diffusion carry of ``get_pc_sampler`` (the S4 solver takes it and ignores
it).  Both resolved names go into the results and the log.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ccsd_tpu_torch import resolve_device
from ccsd_tpu_torch.data.cc_codec import (
    cc_from_incidence,
    convert_CC_to_graphs,
    convert_graphs_to_CCs,
)
from ccsd_tpu_torch.data.loader import init_flags
from ccsd_tpu_torch.diffusion.losses import get_score_fn, get_score_fn_cc
from ccsd_tpu_torch.diffusion.sde import load_sde
from ccsd_tpu_torch.diffusion.solvers import get_pc_sampler, get_s4_solver
from ccsd_tpu_torch.eval.cc_stats import eval_CC_list
from ccsd_tpu_torch.eval.graphs import adjs_to_graphs
from ccsd_tpu_torch.eval.stats import eval_graph_list, load_eval_settings
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.ops.cells import get_spec, rank2_dim
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
from ccsd_tpu_torch.utils.logger import Logger

NAMES = ("x", "adj")
NAMES_CC = ("x", "adj", "rank2")
CC_EVAL_MAX_CELLS = 200_000  # sample.cc_eval_max_cells when absent, as in JAX
# the CC datasets whose bf16 score networks the JAX package cleared, and so
# samples in bf16 by default (ccsd_tpu/sampling/sampler.py:96-108)
BF16_SCORE_CLEARED = {"community_small_CC", "ego_small_CC"}
BF16_NAMES = ("bf16", "bfloat16")


def score_dtype_default(is_cc: bool, dataset) -> str:
    """The default of ``sample.score_dtype`` (JAX sampler.py:111-113)."""
    return "bf16" if is_cc and str(dataset) in BF16_SCORE_CLEARED else "f32"


def resolve_dtype(name) -> Optional[torch.dtype]:
    """bf16 for the names of bf16, else None (f32), as the JAX sampler reads
    ``sample.dtype`` and ``sample.score_dtype``."""
    return torch.bfloat16 if str(name).lower() in BF16_NAMES else None


def sample_dtypes(cfg, configt, is_cc: bool) -> Dict[str, Optional[torch.dtype]]:
    """{"score_dtype": ..., "dtype": ...} of a sampling config, resolved:
    bf16 or None (f32)."""
    default = score_dtype_default(is_cc, configt.data.data)
    return {"score_dtype": resolve_dtype(cfg.sample.get("score_dtype", default)),
            "dtype": resolve_dtype(cfg.sample.get("dtype", "f32"))}


def dtype_name(dtype: Optional[torch.dtype]) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32"


def left_f32_note(dtypes: Dict[str, Optional[torch.dtype]]) -> str:
    """What a run whose reverse diffusion left f32 says of it, naming the
    bf16 modes it ran with."""
    bf16 = [f"sample.{k}: bf16" for k, v in dtypes.items() if v is not None]
    return ("the reverse diffusion left f32 (non-finite values, quantized to 1), so these "
            "samples and their scores are not valid; "
            + (f"it ran with {' and '.join(bf16)}: --score-dtype f32 --dtype f32 samples in f32"
               if bf16 else "it ran in f32"))


def worker_kwargs_from_config(data_cfg) -> Dict[str, Any]:
    """CC-eval worker kwargs from a config's data section (JAX
    ``worker_kwargs_from_config``, sampler.py:116-125)."""
    return dict(
        min_node_val=data_cfg.min_node_val, max_node_val=data_cfg.max_node_val,
        node_label=data_cfg.node_label, min_edge_val=data_cfg.min_edge_val,
        max_edge_val=data_cfg.max_edge_val, edge_label=data_cfg.edge_label,
        d_min=data_cfg.d_min, d_max=data_cfg.d_max, N=data_cfg.max_node_num,
    )


def cc_eval_cells(cfg) -> int:
    """Columns of the dense eval incidence, sum_k C(N, k) for k in
    [d_min, d_max] (3 and 3 when absent)."""
    d = cfg.data
    return rank2_dim(int(d.max_node_num), int(d.get("d_min", 3)), int(d.get("d_max", 3)))[1]


def cc_eval_tractable(cfg) -> bool:
    """The JAX sampler's gate on the lifted-CC eval (``_cc_eval_tractable``,
    sampler.py:186-206): at most ``sample.cc_eval_max_cells`` cells (grid's
    N = 361 gives ~7.8e6, an incidence no implementation can hold)."""
    return cc_eval_cells(cfg) <= int(cfg.sample.get("cc_eval_max_cells", CC_EVAL_MAX_CELLS))


def load_sampling_fn(config_train, config_sampler, config_sample, batch_size: int,
                     is_cc: bool = False):
    """The reverse-diffusion closure of a config (JAX ``load_sampling_fn``,
    ccsd_tpu/sampling/sampler.py:49-93): ``get_s4_solver`` for
    ``sampler.predictor: S4`` (which takes no corrector, step count or
    probability flow), else ``get_pc_sampler``; in CC mode over the
    config's full cell universe; ``sample.dtype`` gives the carry's dtype."""
    d = config_train.data
    N = int(d.max_node_num)
    sdes = [load_sde(config_train.sde[k]) for k in ("x", "adj")]
    kw = dict(snr=config_sampler.snr, scale_eps=config_sampler.scale_eps,
              denoise=config_sample.noise_removal, eps=config_sample.eps,
              carry_dtype=resolve_dtype(config_sample.get("dtype", "f32")))
    if is_cc:
        spec = get_spec(N, int(d.d_min), int(d.d_max))
        kw.update(is_cc=True, sde_rank2=load_sde(config_train.sde.rank2), spec=spec,
                  shape_rank2=(batch_size, spec.num_edges, spec.num_cells))
    shapes = ((batch_size, N, int(d.max_feat_num)), (batch_size, N, N))
    if config_sampler.predictor == "S4":
        return get_s4_solver(*sdes, *shapes, **kw)
    return get_pc_sampler(*sdes, *shapes, predictor=config_sampler.predictor,
                          corrector=config_sampler.corrector, n_steps=config_sampler.n_steps,
                          probability_flow=config_sample.probability_flow, **kw)


def sampling_rounds(batch_size: int, num_test: int, divide_batch=None,
                    max_samples=None) -> Tuple[int, int]:
    """(graphs a round, rounds) of the evaluation protocol (JAX
    sampler.py:244-258)."""
    if divide_batch:
        batch_size //= int(divide_batch)
    n_rounds = max(1, math.ceil(num_test / batch_size))
    if max_samples:
        n_rounds = min(n_rounds, max(1, math.ceil(int(max_samples) / batch_size)))
    return batch_size, n_rounds


class Sampler:
    """Graph or CC sampler (``config.is_cc``).

    ``config`` holds the ``sampler`` and ``sample`` sections, plus either
    ``ckpt`` (a port or JAX checkpoint under ``<folder>/checkpoints/<data>/``)
    or the training sections (``data``, ``sde``, ``model``) for a seeded
    init.
    ``train_adjs`` (M, N, N) is the training set the node counts are drawn
    from; ``test_adjs`` the test split the protocol sizes its output by and
    scores it against.  The device defaults to CUDA and raises when there
    is none.  ``log`` prints the MMDs as the JAX sampler logs them.
    """

    def __init__(self, config, train_adjs: np.ndarray, test_adjs: Optional[np.ndarray] = None,
                 device=None, log: bool = True):
        self.config = config
        self.train_adjs = np.asarray(train_adjs, np.float32)
        self.test_adjs = None if test_adjs is None else np.asarray(test_adjs, np.float32)
        self.device = resolve_device(device)
        self.logger = Logger(verbose=log)
        self.is_cc = bool(config.get("is_cc", False))
        self.names = NAMES_CC if self.is_cc else NAMES

    def load_models(self, read=None):
        """(train config, {name: module on the device}, source of the
        weights).  ``read``: what ``read_checkpoint`` gave for the config,
        to load a checkpoint the caller has read already."""
        cfg = self.config
        name = cfg.get("ckpt")

        def defs_of(defs):  # the fused fast path by default at inference
            return with_fused(defs, bool(cfg.sample.get("fused", True)),
                              fast=bool(cfg.sample.get("fast", True)))

        if name:
            use_ema = bool(cfg.sample.get("use_ema", False))
            ckpt, path, port = read or read_checkpoint(cfg)
            configt = AttrDict(ckpt["model_config"])
            defs = defs_of({n: ckpt[f"params_{n}"] for n in self.names})
            models = {}
            for n in self.names:
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
            defs = defs_of(dict(zip(self.names, load_model_params(cfg, is_cc=self.is_cc))))
            models = {n: load_model(defs[n], generator=g) for n in self.names}
            source = f"seeded init (seed {int(cfg.get('seed', 0))})"
        models = {n: m.to(self.device).eval() for n, m in models.items()}
        return configt, models, source

    def sample(self, num_samples: Optional[int] = None) -> Dict[str, Any]:
        """Sample by the evaluation protocol, or ``num_samples`` graphs in
        rounds of the protocol's batch when that is given (no cap); with no
        test split and no count, one round.  Returns the kept graphs as
        numpy (``adj``, ``x``, ``flags``), ``finite``, ``sampling_time`` and
        ``steps_per_s`` of the sampling loop, and with a test split and
        ``sample.eval`` on, ``mmd``, ``cc_mmd`` (or None) and
        ``eval_seconds``.  CC mode adds the quantized ``rank2`` (uint8), the
        kept CCs (``ccs``) and ``cells_per_cc``, their mean rank-2 cells."""
        cfg = self.config
        configt, models, source = self.load_models()
        test = self.test_adjs
        batch_size, n_rounds = sampling_rounds(
            int(configt.data.batch_size), 1 if test is None else len(test),
            cfg.sample.get("divide_batch"), cfg.sample.get("max_samples"))
        n = batch_size if test is None else len(test)
        if num_samples is not None:
            n = int(num_samples)
            n_rounds = max(1, math.ceil(n / batch_size))
        dtypes = sample_dtypes(cfg, configt, self.is_cc)
        self.logger.log(", ".join(f"sample.{k}: {dtype_name(v)}" for k, v in dtypes.items()))
        sdes = {k: load_sde(configt.sde[k]) for k in self.names}
        sampling_fn = load_sampling_fn(configt, cfg.sampler, cfg.sample, batch_size,
                                       self.is_cc)
        if self.is_cc:
            score_fns = [get_score_fn_cc(sdes[k], models[k], dtypes["score_dtype"],
                                         dtypes["dtype"]) for k in self.names]
        else:
            score_fns = [get_score_fn(sdes[k], models[k], dtypes["score_dtype"])
                         for k in self.names]

        seed = int(cfg.sample.get("seed", 42))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        rng = np.random.default_rng(seed)
        xs, adjs, rank2s, flags_all = [], [], [], []
        finite = True
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            flags = torch.from_numpy(init_flags(self.train_adjs, batch_size, rng))
            out = sampling_fn(*score_fns, flags.to(self.device), gen)
            # quantize maps NaN to 1, so finiteness is read before it
            outs = [out.x, out.adj] + ([out.rank2] if self.is_cc else [])
            finite &= all(bool(v.isfinite().all()) for v in outs)
            adjs.append(quantize(out.adj).cpu().numpy())
            xs.append(out.x.cpu().numpy())
            if self.is_cc:
                rank2s.append(quantize(out.rank2).to(torch.uint8).cpu().numpy())
            flags_all.append(flags.numpy())
        seconds = time.perf_counter() - t0
        results = {
            "adj": np.concatenate(adjs)[:n],
            "x": np.concatenate(xs)[:n],
            "flags": np.concatenate(flags_all)[:n],
            "finite": finite,
            "sampling_time": seconds,
            "steps_per_s": n_rounds * sdes["adj"].N / seconds,
            "weights": source,
            "device": str(self.device),
            **{k: dtype_name(v) for k, v in dtypes.items()},
        }
        if not finite:
            results["note"] = left_f32_note(dtypes)
            self.logger.log(results["note"])
        ccs = None
        if self.is_cc:
            d = configt.data
            results["rank2"] = np.concatenate(rank2s)[:n]
            results["cells_per_cc"] = float(results["rank2"].any(1).sum(1).mean())
            ccs = [cc_from_incidence([x, a, r], int(d.d_min), int(d.d_max))
                   for x, a, r in zip(results["x"], results["adj"], results["rank2"])]
            results["ccs"] = ccs
        if test is not None and cfg.sample.get("eval", True):
            t0 = time.perf_counter()
            results.update(self.evaluate(test, results["adj"], ccs))
            results["eval_seconds"] = time.perf_counter() - t0
        self.save_samples(results)
        return results

    def lift(self, adjs: np.ndarray) -> list:
        """The CCs of the graphs ``adjs`` by the config's lift, over the
        config's ``max_node_num`` nodes."""
        d = self.config.data
        return convert_graphs_to_CCs(
            adjs_to_graphs(adjs), lifting_procedure=d.lifting_procedure,
            lifting_procedure_kwargs=d.get("lifting_procedure_kwargs"),
            max_nb_nodes=d.max_node_num)

    def evaluate(self, test_adjs: np.ndarray, adjs: Optional[np.ndarray],
                 ccs: Optional[list] = None, cc_eval: bool = True) -> Dict[str, Any]:
        """``mmd`` and ``cc_mmd`` of ``adjs`` against ``test_adjs``, logged as
        the JAX sampler logs them.  Graph mode: ``cc_mmd`` is the lifted-CC
        MMDs (None where the config has no lift or the lift is
        intractable).  CC mode: the generated CCs ``ccs`` (default: the
        lift of ``adjs``) against the test graphs' lift, and ``mmd`` of
        their 1-skeletons; ``cc_eval`` off leaves ``cc_mmd`` None."""
        cfg = self.config
        if self.is_cc:
            methods, kernels = load_eval_settings()
            test_ccs = self.lift(test_adjs)
            ccs = self.lift(adjs) if ccs is None else ccs
            out: Dict[str, Any] = {
                "mmd": eval_graph_list(convert_CC_to_graphs(test_ccs),
                                       convert_CC_to_graphs(ccs),
                                       methods=methods, kernels=kernels),
                "cc_mmd": eval_CC_list(test_ccs, ccs, worker_kwargs_from_config(cfg.data),
                                       cc_nb_eval=cfg.sample.get("cc_nb_eval", 1000))
                if cc_eval else None,
            }
        else:
            out = self._evaluate_graphs(test_adjs, adjs)
        for k, v in out["mmd"].items():
            self.logger.log(f"{k:9s} : {v:.6f}")
        for k, v in (out["cc_mmd"] or {}).items():
            self.logger.log(f"{k:24s} : {v:.6f}")
        return out

    def _evaluate_graphs(self, test_adjs: np.ndarray, adjs: np.ndarray) -> Dict[str, Any]:
        cfg = self.config
        test_graphs, graphs = adjs_to_graphs(test_adjs), adjs_to_graphs(adjs)
        methods, kernels = load_eval_settings()
        out: Dict[str, Any] = {
            "mmd": eval_graph_list(test_graphs, graphs, methods=methods, kernels=kernels),
            "cc_mmd": None,
        }
        lift = cfg.data.get("lifting_procedure")
        if lift and not cc_eval_tractable(cfg):
            self.logger.log(
                f"lifted-CC eval skipped: {cc_eval_cells(cfg)} candidate cells at "
                f"N={cfg.data.max_node_num} exceeds cc_eval_max_cells="
                f"{int(cfg.sample.get('cc_eval_max_cells', CC_EVAL_MAX_CELLS))}")
        elif lift:
            lift_kw = dict(lifting_procedure=lift,
                           lifting_procedure_kwargs=cfg.data.get("lifting_procedure_kwargs"),
                           max_nb_nodes=cfg.data.max_node_num)
            out["cc_mmd"] = eval_CC_list(
                convert_graphs_to_CCs(test_graphs, **lift_kw),
                convert_graphs_to_CCs(graphs, **lift_kw),
                worker_kwargs_from_config(cfg.data),
                cc_nb_eval=cfg.sample.get("cc_nb_eval", 1000))
        return out

    def save_samples(self, results: Dict[str, Any]) -> str:
        """The kept graphs (and rank-2 incidences) to
        ``<folder>/samples/<data>/samples.npz``, written whole or not at all."""
        cfg = self.config
        out_dir = os.path.join(cfg.get("folder", "./"), "samples", str(cfg.data.data))
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "samples.npz")
        tmp = os.path.join(out_dir, f"samples.{os.getpid()}.tmp.npz")
        extra = {"rank2": results["rank2"]} if "rank2" in results else {}
        np.savez(tmp, adj=results["adj"], x=results["x"], flags=results["flags"], **extra)
        os.replace(tmp, path)
        return path


def read_checkpoint(cfg):
    """(the checkpoint ``cfg.ckpt`` names under ``cfg.folder``, its path,
    whether it is the port's ``.pth``; else the JAX ``.ckpt.pkl``)."""
    folder, data, name = cfg.get("folder", "./"), str(cfg.data.data), str(cfg.ckpt)
    path = port_ckpt_path(folder, data, name)
    if os.path.exists(path):
        return load_port_ckpt(path, map_location="cpu"), path, True
    path = ckpt_path(folder, data, name)
    return load_ckpt_file(path), path, False


def get_sampler_from_config(config, *args, **kwargs) -> Sampler:
    """``TwoStageSampler`` where ``sample.two_stage`` is set, else
    ``Sampler`` (ccsd_tpu/sampling/sampler.py:474-478)."""
    if config.sample.get("two_stage"):
        from ccsd_tpu_torch.sampling.two_stage_sampler import TwoStageSampler

        return TwoStageSampler(config, *args, **kwargs)
    return Sampler(config, *args, **kwargs)
