"""Adjacency score network in the higher-order (CC) domain.

Port of ccsd_tpu/models/score_a_cc.py:25-161 (``_graph_layers`` and
ScoreNetworkA_CC; the ``*_Base_CC`` variant is not ported).  A graph branch
of ``AttentionLayer``s over the adjacency powers (the kernels of
``models/attention.py``: ``gmh_attention`` unfused, ``channel_agg`` and
``gmh_scores`` fused) beside a Hodge branch of ``HodgeAdjAttentionLayer``s
on the E × E dual of those powers and the rank-2 tensor; the final ELU MLP
reads both, the Hodge channels scattered back onto the adjacency.  As in
the JAX package the fused path takes only ``fused``: f32 head scores and
the concat final layer (``with_fused`` sets the fast lowerings for
ScoreNetworkA alone).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccsd_tpu_torch.models.attention import AttentionLayer
from ccsd_tpu_torch.models.hodge_nn import HodgeAdjAttentionLayer
from ccsd_tpu_torch.models.nn import MLP, check_no_bn
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.hodge import adj_to_hodgedual, hodgedual_to_adj
from ccsd_tpu_torch.ops.masks import default_mask, mask_adjs, pow_tensor


class ScoreNetworkA_CC(nn.Module):
    def __init__(self, max_feat_num: int, max_node_num: int, d_min: int, d_max: int,
                 nhid: int, nhid_h: int, num_layers: int, num_layers_h: int,
                 num_linears: int, num_linears_h: int, c_init: int, c_hid: int,
                 c_hid_h: int, c_final: int, c_final_h: int, adim: int, adim_h: int,
                 num_heads: int = 4, num_heads_h: int = 4, conv: str = "GCN",
                 conv_hodge: str = "HCN", use_bn: bool = False, is_cc: bool = True,
                 fused: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.max_node_num, self.c_init = max_node_num, c_init
        self.spec = spec = get_spec(max_node_num, d_min, d_max)
        g = generator
        layers = []
        for k in range(num_layers):
            if k == 0:
                dims = (max_feat_num, nhid, nhid, c_init, c_hid)
            elif k == num_layers - 1:
                dims = (nhid, adim, nhid, c_hid, c_final)
            else:
                dims = (nhid, adim, nhid, c_hid, c_hid)
            layers.append(AttentionLayer(num_linears, *dims, num_heads, conv,
                                         fused=fused, generator=g))
        self.layers = nn.ModuleList(layers)
        hodge = []
        for k in range(num_layers_h):
            if k == 0:
                dims = (c_init, nhid_h, c_hid_h)
            elif k == num_layers_h - 1:
                dims = (c_hid_h, adim_h, c_final_h)
            else:
                dims = (c_hid_h, adim_h, c_hid_h)
            hodge.append(HodgeAdjAttentionLayer(num_linears_h, *dims, spec, num_heads_h,
                                                conv_hodge, generator=g))
        self.layers_hodge = nn.ModuleList(hodge)
        self.fdim = (c_hid * (num_layers - 1) + c_final + c_init
                     + c_hid_h * (num_layers_h - 1) + c_final_h + c_init)
        self.final = MLP(3, self.fdim, 2 * self.fdim, 1, act="elu", generator=g)
        self.register_buffer("mask", default_mask(max_node_num), persistent=False)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, rank2: torch.Tensor,
                flags: Optional[torch.Tensor] = None) -> torch.Tensor:
        adjc = pow_tensor(adj, self.c_init)
        hodge_adjc = adj_to_hodgedual(adjc)
        adj_list = [adjc]
        h = x
        for layer in self.layers:
            h, adjc = layer(h, adjc, flags)
            adj_list.append(adjc)
        hodge_list = [hodge_adjc]
        r = rank2
        for layer in self.layers_hodge:
            hodge_adjc, r = layer(hodge_adjc, r, flags)
            hodge_list.append(hodge_adjc)
        adj_hodge = hodgedual_to_adj(torch.cat(hodge_list, dim=1))
        feats = torch.cat(adj_list + [adj_hodge], dim=1).permute(0, 2, 3, 1)
        score = self.final(feats)[..., 0]
        return mask_adjs(score * self.mask[None], flags)
