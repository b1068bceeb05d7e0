"""Load a JAX parameter tree into the port's modules.

The tree is the nested dict/list of numpy arrays that the ``init`` of
ccsd_tpu's ScoreNetworkX, ScoreNetworkX_GMH, ScoreNetworkA, ScoreNetworkA_CC,
ScoreNetworkA_Base_CC or ScoreNetworkF returns (or that a ``.ckpt.pkl``
holds).  This is the exact inverse of ccsd_tpu/utils/torch_convert.py:59-85,
:116-149 and :152-220:

  * a Linear's ``w`` (in, out) becomes ``nn.Linear.weight`` (out, in);
  * a DenseGCNConv or DenseHCNConv ``weight`` (in, out) and ``bias`` are
    copied as they are;
  * an MLP of one layer maps onto ``linear``, a deeper one onto ``linears.{i}``;
  * a HodgeAttention's ``q``/``k`` map onto ``ccnn_q``/``ccnn_k``;
  * a HodgeBaselineLayer's ``layers[i].mlp_layer`` maps onto
    ``layers.{i}.mlp_layer``, beside ``mlp_rank2`` and ``mlp_hodge``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ccsd_tpu_torch.models.attention import Attention, AttentionLayer
from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.hodge_nn import (
    BaselineBlock,
    DenseHCNConv,
    HodgeAdjAttentionLayer,
    HodgeAttention,
    HodgeBaselineLayer,
    HodgeNetworkLayer,
)
from ccsd_tpu_torch.models.nn import MLP
from ccsd_tpu_torch.models.score_a import ScoreNetworkA
from ccsd_tpu_torch.models.score_a_cc import ScoreNetworkA_Base_CC, ScoreNetworkA_CC
from ccsd_tpu_torch.models.score_f import ScoreNetworkF
from ccsd_tpu_torch.models.score_x import ScoreNetworkX, ScoreNetworkX_GMH

SD = Dict[str, np.ndarray]


def _mlp(m: MLP, tree: dict, p: str, sd: SD) -> None:
    names = ["linear"] if m.num_layers == 1 else [
        f"linears.{i}" for i in range(m.num_layers)]
    for name, lin in zip(names, tree["linears"]):
        sd[f"{p}{name}.weight"] = np.asarray(lin["w"]).T
        sd[f"{p}{name}.bias"] = np.asarray(lin["b"])


def _gcn(tree: dict, p: str, sd: SD) -> None:
    sd[f"{p}weight"] = np.asarray(tree["weight"])
    if "bias" in tree:
        sd[f"{p}bias"] = np.asarray(tree["bias"])


def _walk(m: nn.Module, tree: Any, p: str, sd: SD) -> None:
    if isinstance(m, (DenseGCNConv, DenseHCNConv)):
        _gcn(tree, p, sd)
    elif isinstance(m, MLP):
        _mlp(m, tree, p, sd)
    elif isinstance(m, Attention):
        for name, key in (("gnn_q", "q"), ("gnn_k", "k"), ("gnn_v", "v")):
            _walk(getattr(m, name), tree[key], f"{p}{name}.", sd)
    elif isinstance(m, AttentionLayer):
        for i, a in enumerate(m.attn):
            _walk(a, tree["attn"][i], f"{p}attn.{i}.", sd)
        _walk(m.mlp, tree["mlp"], f"{p}mlp.", sd)
        _walk(m.multi_channel, tree["multi_channel"], f"{p}multi_channel.", sd)
    elif isinstance(m, HodgeAttention):
        _walk(m.ccnn_q, tree["q"], f"{p}ccnn_q.", sd)
        _walk(m.ccnn_k, tree["k"], f"{p}ccnn_k.", sd)
    elif isinstance(m, HodgeAdjAttentionLayer):
        for i, a in enumerate(m.attn):
            _walk(a, tree["attn"][i], f"{p}attn.{i}.", sd)
        _walk(m.mlp_value, tree["mlp_value"], f"{p}mlp_value.", sd)
        _walk(m.mlp_attention, tree["mlp_attention"], f"{p}mlp_attention.", sd)
    elif isinstance(m, BaselineBlock):
        _walk(m.mlp_layer, tree["mlp_layer"], f"{p}mlp_layer.", sd)
    elif isinstance(m, HodgeBaselineLayer):
        for i, b in enumerate(m.layers):
            _walk(b, tree["layers"][i], f"{p}layers.{i}.", sd)
        _walk(m.mlp_rank2, tree["mlp_rank2"], f"{p}mlp_rank2.", sd)
        _walk(m.mlp_hodge, tree["mlp_hodge"], f"{p}mlp_hodge.", sd)
    elif isinstance(m, HodgeNetworkLayer):
        _walk(m.layer, tree["layer"], f"{p}layer.", sd)
    elif isinstance(m, (ScoreNetworkX, ScoreNetworkX_GMH, ScoreNetworkA, ScoreNetworkA_CC,
                        ScoreNetworkA_Base_CC, ScoreNetworkF)):
        for k, layer in enumerate(m.layers):
            _walk(layer, tree["layers"][k], f"{p}layers.{k}.", sd)
        for k, layer in enumerate(getattr(m, "layers_hodge", ())):
            _walk(layer, tree["layers_hodge"][k], f"{p}layers_hodge.{k}.", sd)
        _walk(m.final, tree["final"], f"{p}final.", sd)
    else:
        raise NotImplementedError(f"No JAX loader for {type(m).__name__}")


def state_dict_from_jax(module: nn.Module, tree: Any) -> SD:
    """The port state dict (numpy) that a JAX parameter tree maps onto."""
    sd: SD = {}
    _walk(module, tree, "", sd)
    return sd


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX parameter tree into ``module`` (strict) and return it."""
    sd = state_dict_from_jax(module, tree)
    module.load_state_dict(
        {k: torch.tensor(np.asarray(v, dtype=np.float32))
         for k, v in sd.items()},
        strict=True,
    )
    return module
