"""Read a checkpoint written by the JAX package, without JAX.

A ``.ckpt.pkl`` (ccsd_tpu/training/checkpoint.py:31-43) is a pickle of
numpy-ified pytrees: ``{model_config, params_{x,adj}, {x,adj}_params,
{x,adj}_opt_state, ema_{x,adj}}``.  The EMA entry is a
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
    """The parameter tree of model ``name`` ('x' or 'adj'): its EMA shadow
    when ``use_ema``, else the raw parameters (ccsd_tpu sampler.py:146-155)."""
    if use_ema:
        return ckpt[f"ema_{name}"][EMA_SHADOW]
    return ckpt[f"{name}_params"]
