"""Model registry and config -> hyperparameter marshalling, graph and CC
mode.

Port of ccsd_tpu/models/registry.py:28-66 and :95-200 (the GMH branch of
ScoreNetworkX_GMH, and the CC branch for ScoreNetworkA_CC,
ScoreNetworkA_Base_CC and ScoreNetworkF; the GDSS BaselineNetwork, which
no config names, is not ported).  A CC config whose adjacency model is
the graph ScoreNetworkA (the two-stage model's) gets the graph X and A
definitions, marked ``is_cc``, beside its ScoreNetworkF.  A model definition
may carry ``fused`` (``model.fused`` in a training config, or ``with_fused``
at sampling time), which picks the channel-folded implementation of the
same function with the same parameters, and the fused path's lowering
fields; ``load_model`` passes them on as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ccsd_tpu_torch.models.score_a import ScoreNetworkA
from ccsd_tpu_torch.models.score_a_cc import ScoreNetworkA_Base_CC, ScoreNetworkA_CC
from ccsd_tpu_torch.models.score_f import ScoreNetworkF
from ccsd_tpu_torch.models.score_x import ScoreNetworkX, ScoreNetworkX_GMH

MODELS = {"ScoreNetworkX": ScoreNetworkX, "ScoreNetworkX_GMH": ScoreNetworkX_GMH,
          "ScoreNetworkA": ScoreNetworkA, "ScoreNetworkA_CC": ScoreNetworkA_CC,
          "ScoreNetworkA_Base_CC": ScoreNetworkA_Base_CC, "ScoreNetworkF": ScoreNetworkF}

# the models whose definitions accept the channel-folded ``fused`` path
# (the JAX set, ccsd_tpu/models/registry.py:31-37)
FUSED_CAPABLE = {"ScoreNetworkX_GMH", "ScoreNetworkA", "ScoreNetworkA_CC",
                 "ScoreNetworkA_Base_CC", "ScoreNetworkF"}


def with_fused(defs: Dict[str, Dict[str, Any]], enable: bool = True,
               fast: bool = True) -> Dict[str, Dict[str, Any]]:
    """Model-def dicts with the fused path toggled where supported, as the
    samplers use them (ccsd_tpu/models/registry.py:40-66).

    ``fast`` adds the JAX package's default sampling lowerings unless a
    definition names its own: bf16 head scores (``mulreduce_h_bf16``) of
    ScoreNetworkA and ScoreNetworkX_GMH, and the concat-free ``blocksum``
    final layer of ScoreNetworkA.
    """
    out = {}
    for name, d in defs.items():
        d = dict(d)
        mt = d.get("model_type")
        if mt in FUSED_CAPABLE:
            d["fused"] = enable
        if enable and fast and mt in ("ScoreNetworkA", "ScoreNetworkX_GMH"):
            d.setdefault("scores_impl", "mulreduce_h_bf16")
        if enable and fast and mt == "ScoreNetworkA":
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
            f"Model Name <{model_type}> is unknown or not ported. Please select from "
            f"{sorted(MODELS)}"
        )
    return MODELS[model_type](**params_, generator=generator)


def load_model_params(config, is_cc: bool = False) -> Tuple[Dict[str, Any], ...]:
    """Per-model hyperparameter dicts: (x, adj) of a graph config, (x, adj,
    rank2) of a CC one."""
    is_cc = bool(is_cc or config.get("is_cc", False))
    cm = config.model
    max_node_num = config.data.max_node_num
    params_x = {
        "is_cc": is_cc,
        "model_type": cm.x,
        "max_feat_num": config.data.max_feat_num,
        "depth": cm.depth,
        "nhid": cm.nhid,
        "use_bn": cm.use_bn,
    }
    if "GMH" in cm.x:  # JAX registry.py:117-132
        params_x.update(num_linears=cm.num_linears, c_init=cm.c_init, c_hid=cm.c_hid,
                        c_final=cm.c_final, adim=cm.adim, num_heads=cm.num_heads,
                        conv=cm.conv)
    params_adj = {
        "is_cc": is_cc,
        "model_type": cm.adj,
        "max_feat_num": config.data.max_feat_num,
        "max_node_num": max_node_num,
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
    if not is_cc:
        return params_x, params_adj

    d_min, d_max = config.data.d_min, config.data.d_max
    if cm.adj == "ScoreNetworkA_CC":
        params_adj.update(
            d_min=d_min, d_max=d_max, nhid_h=cm.nhid_h,
            num_layers_h=cm.num_layers_h, num_linears_h=cm.num_linears_h,
            c_hid_h=cm.c_hid_h, c_final_h=cm.c_final_h, adim_h=cm.adim_h,
            num_heads_h=cm.num_heads_h, conv_hodge=cm.conv_hodge,
        )
    elif cm.adj == "ScoreNetworkA_Base_CC":
        params_adj.update(
            d_min=d_min, d_max=d_max, nhid_h=cm.nhid_h,
            num_layers_h=cm.num_layers_h, num_linears_h=cm.num_linears_h,
            c_hid_h=cm.c_hid_h, c_final_h=cm.c_final_h, hidden_h=cm.hidden_h,
        )
    params_rank2 = {
        "is_cc": is_cc,
        "model_type": cm.rank2,
        "num_layers_mlp": cm.num_layers_mlp,
        "num_layers": cm.num_layers_h,
        "num_linears": cm.num_linears_h,
        "nhid": cm.nhid_h,
        "c_hid": cm.c_hid_h,
        "c_final": cm.c_final_h,
        "cnum": cm.cnum,
        "max_node_num": max_node_num,
        "d_min": d_min,
        "d_max": d_max,
        "use_hodge_mask": cm.use_hodge_mask,
        "use_bn": cm.use_bn,
    }
    if cm.get("fused") and params_rank2["model_type"] in FUSED_CAPABLE:
        params_rank2["fused"] = True
    return params_x, params_adj, params_rank2
