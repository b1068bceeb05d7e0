"""Model registry and config -> hyperparameter marshalling (graph mode).

Port of ccsd_tpu/models/registry.py:95-166.  A JAX checkpoint's model
definition may carry ``fused`` (``model.fused`` in its config), which picks
the channel-folded implementation of the same function with the same
parameters; the port has one implementation, so such a definition loads
onto it unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ccsd_tpu_torch.models.score_a import ScoreNetworkA
from ccsd_tpu_torch.models.score_x import ScoreNetworkX

MODELS = {"ScoreNetworkX": ScoreNetworkX, "ScoreNetworkA": ScoreNetworkA}


def load_model(params: Dict[str, Any],
               generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Instantiate a model from a params dict with 'model_type'."""
    params_ = {k: v for k, v in params.items() if k != "fused"}
    model_type = params_.pop("model_type", None)
    if model_type not in MODELS:
        raise ValueError(
            f"Model Name <{model_type}> is not ported. Please select from "
            f"{sorted(MODELS)}"
        )
    return MODELS[model_type](**params_, generator=generator)


def load_model_params(config, is_cc: bool = False) -> Tuple[Dict[str, Any], ...]:
    """Per-model hyperparameter dicts of a graph config."""
    if is_cc or config.get("is_cc", False):
        raise NotImplementedError("CC mode is not ported yet")
    cm = config.model
    params_x = {
        "is_cc": False,
        "model_type": cm.x,
        "max_feat_num": config.data.max_feat_num,
        "depth": cm.depth,
        "nhid": cm.nhid,
        "use_bn": cm.use_bn,
    }
    params_adj = {
        "is_cc": False,
        "model_type": cm.adj,
        "max_feat_num": config.data.max_feat_num,
        "max_node_num": config.data.max_node_num,
        "nhid": cm.nhid,
        "num_layers": cm.num_layers,
        "num_linears": cm.num_linears,
        "c_init": cm.c_init,
        "c_hid": cm.c_hid,
        "c_final": cm.c_final,
        "adim": cm.adim,
        "num_heads": cm.num_heads,
        "conv": cm.conv,
        "use_bn": cm.use_bn,
    }
    return params_x, params_adj
