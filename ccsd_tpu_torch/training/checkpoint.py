"""Checkpoints: the port's own, and those written by the JAX package.

The port's checkpoint (``<folder>/checkpoints/<data>/<name>.pth``) is a
``torch.save`` dict in the reference's layout (ccsd/src/trainer.py:258-283):
``model_config``, ``params_{x,adj}`` (the model definitions),
``{x,adj}_state_dict`` and ``ema_{x,adj}`` (``{decay, num_updates,
shadow_params}``), plus what a run needs to resume as it would have gone
on: ``{x,adj}_opt_state``, ``epoch``, ``step``, ``history`` and the state
of the data order and noise generators (``rng``).  A CC run adds the same
four entries for ``rank2`` (ScoreNetworkF).  It holds tensors,
numbers, strings and plain containers only, so it loads with
``weights_only=True``.

A JAX ``.ckpt.pkl`` (ccsd_tpu/training/checkpoint.py:31-43) is a pickle of
numpy-ified pytrees: ``{model_config, params_{x,adj}, {x,adj}_params,
{x,adj}_opt_state, ema_{x,adj}}`` (and ``rank2``'s in CC mode).  The EMA entry is a
``ccsd_tpu.training.ema.EMAState`` and the optimizer entries are optax state
NamedTuples, so a plain ``pickle.load`` would import jax, optax and
ccsd_tpu.  :class:`_Unpickler` maps every class of those packages onto
:class:`Record`, a plain tuple of the fields; the arrays inside are
numpy.  ``EMAState`` keeps its field order ``(decay,
num_updates, shadow_params)`` (ccsd_tpu/training/ema.py:17-20).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

SHIMMED = ("ccsd_tpu", "optax", "jax", "jaxlib", "flax", "chex")
EMA_SHADOW = 2  # index of shadow_params in EMAState


class Record(tuple):
    """Stand-in for a NamedTuple of a package the port does not import."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.split(".")[0] in SHIMMED:
            return Record
        return super().find_class(module, name)


def load_ckpt_file(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def ckpt_path(folder: str, dataset: str, name: str) -> str:
    return os.path.join(folder, "checkpoints", dataset, f"{name}.ckpt.pkl")


def params_from_ckpt(ckpt: Dict[str, Any], name: str, use_ema: bool):
    """The parameter tree of model ``name`` ('x', 'adj', 'rank2'): its EMA shadow
    when ``use_ema``, else the raw parameters (ccsd_tpu sampler.py:146-155)."""
    if use_ema:
        return ckpt[f"ema_{name}"][EMA_SHADOW]
    return ckpt[f"{name}_params"]


def port_ckpt_path(folder: str, dataset: str, name: str) -> str:
    return os.path.join(folder, "checkpoints", dataset, f"{name}.pth")


def save_port_ckpt(path: str, payload: Dict[str, Any]) -> str:
    """Write atomically (a partial file never takes the name)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_port_ckpt(path: str, map_location=None) -> Dict[str, Any]:
    return torch.load(path, map_location=map_location, weights_only=True)


def state_dict_from_ckpt(ckpt: Dict[str, Any], name: str, model, use_ema: bool):
    """The state dict of model ``name`` in a port checkpoint: its EMA shadow
    (in ``model.parameters()`` order) when ``use_ema``, else the raw one."""
    if not use_ema:
        return ckpt[f"{name}_state_dict"]
    names = [k for k, _ in model.named_parameters()]
    return dict(zip(names, ckpt[f"ema_{name}"]["shadow_params"]))
