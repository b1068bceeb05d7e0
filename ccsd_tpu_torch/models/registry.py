"""Model registry and config -> hyperparameter marshalling (graph mode).

Port of ccsd_tpu/models/registry.py:28-66 and :95-166.  A model definition
may carry ``fused`` (``model.fused`` in a training config, or ``with_fused``
at sampling time), which picks the channel-folded implementation of the
same function with the same parameters, and the fused path's lowering
fields; ``load_model`` passes them on as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ccsd_tpu_torch.models.score_a import ScoreNetworkA
from ccsd_tpu_torch.models.score_x import ScoreNetworkX

MODELS = {"ScoreNetworkX": ScoreNetworkX, "ScoreNetworkA": ScoreNetworkA}

# the ported models whose definitions accept the channel-folded ``fused``
# path (the JAX set, ccsd_tpu/models/registry.py:31-37, less what is not
# ported yet)
FUSED_CAPABLE = {"ScoreNetworkA"}


def with_fused(defs: Dict[str, Dict[str, Any]], enable: bool = True,
               fast: bool = True) -> Dict[str, Dict[str, Any]]:
    """Model-def dicts with the fused path toggled where supported, as the
    samplers use them (ccsd_tpu/models/registry.py:40-66).

    ``fast`` adds the JAX package's default sampling lowerings unless a
    definition names its own: bf16 head scores (``mulreduce_h_bf16``) and
    the concat-free ``blocksum`` final layer of ScoreNetworkA.
    """
    out = {}
    for name, d in defs.items():
        d = dict(d)
        mt = d.get("model_type")
        if mt in FUSED_CAPABLE:
            d["fused"] = enable
        if enable and fast and mt == "ScoreNetworkA":
            d.setdefault("scores_impl", "mulreduce_h_bf16")
            d.setdefault("final_impl", "blocksum")
        out[name] = d
    return out


def load_model(params: Dict[str, Any],
               generator: Optional[torch.Generator] = None) -> torch.nn.Module:
    """Instantiate a model from a params dict with 'model_type'."""
    params_ = dict(params)
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
    # model.fused: the channel-folded path at training time too
    if cm.get("fused"):
        for pd in (params_x, params_adj):
            if pd["model_type"] in FUSED_CAPABLE:
                pd["fused"] = True
    return params_x, params_adj
