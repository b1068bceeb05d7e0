"""Linear layers, MLP and Glorot initialisation; the dtype rules of the
bf16 score networks.

Port of ccsd_tpu/models/nn.py:22-128 onto ``nn.Linear``.  State-dict names
follow the reference: an MLP of one layer holds ``linear``, a deeper one
``linears.{i}``.  BatchNorm is not ported: every config sets
``use_bn: false``, and a model asked for it raises.

The bf16 sampling modes run networks whose tensors are bf16, f32 or both.
The JAX package promotes a product's mixed operands to f32
(``jnp.promote_types``); torch's products raise on them, so the networks
promote explicitly (``promoted``, ``apply_linear``); elementwise ops
promote alike in both.  ``cast_copy`` is the JAX package's cast of a
network's parameters (``diffusion/losses.py``: selective precision, and
the CC networks' following of the bf16 carry), made once by the score
function.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

ACT = {"relu": F.relu, "elu": F.elu, "tanh": torch.tanh}


def glorot_(t: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot/Xavier uniform in place, from an explicit generator."""
    stdv = (6.0 / (fan_in + fan_out)) ** 0.5
    with torch.no_grad():
        return t.uniform_(-stdv, stdv, generator=generator)


def linear(in_dim: int, out_dim: int,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear with Glorot-uniform weight and zero bias."""
    lin = nn.Linear(in_dim, out_dim)
    glorot_(lin.weight, in_dim, out_dim, generator)
    nn.init.zeros_(lin.bias)
    return lin


def promoted(*tensors: Optional[torch.Tensor]):
    """The tensors in their promoted dtype (None kept), as JAX promotes the
    operands of a product; as given where they agree."""
    dts = {t.dtype for t in tensors if t is not None}
    if len(dts) < 2:
        return tensors
    dt = functools.reduce(torch.promote_types, dts)
    return tuple(None if t is None else t.to(dt) for t in tensors)


def apply_linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)`` in the promoted dtype of x and the layer's parameters
    (JAX's ``x @ w + b``)."""
    if x.dtype == lin.weight.dtype:
        return lin(x)
    return F.linear(*promoted(x, lin.weight, lin.bias))


def param_dtype(module: nn.Module) -> torch.dtype:
    return next(module.parameters()).dtype


def cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` whose parameters are ``dtype`` and need no
    gradient; its buffers (f32 constants such as ``default_mask``) are kept,
    as the JAX package casts parameters only.  ``module`` is unchanged."""
    twin = copy.deepcopy(module)
    for p in twin.parameters():
        p.requires_grad_(False)
        p.data = p.data.to(dtype)
    return twin


def check_no_bn(use_bn: bool) -> None:
    if use_bn:
        raise NotImplementedError("use_bn=True is not ported (no config sets it)")


class MLP(nn.Module):
    """n-layer perceptron over the trailing dim; one layer is a Linear."""

    def __init__(self, num_layers: int, input_dim: int, hidden_dim: int,
                 output_dim: int, use_bn: bool = False, act: str = "relu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_layers < 1:
            raise ValueError("Number of layers should be >= 1.")
        check_no_bn(use_bn)
        self.num_layers = num_layers
        self.act = ACT[act]
        if num_layers == 1:
            self.linear = linear(input_dim, output_dim, generator)
        else:
            dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
            self.linears = nn.ModuleList(
                linear(dims[i], dims[i + 1], generator) for i in range(num_layers)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.num_layers == 1:
            return apply_linear(self.linear, x)
        h = x
        for lin in self.linears[:-1]:
            h = self.act(apply_linear(lin, h))
        return apply_linear(self.linears[-1], h)
