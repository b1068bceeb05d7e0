"""Adjacency score networks in the higher-order (CC) domain.

Port of ccsd_tpu/models/score_a_cc.py:25-273: ``_graph_layers``,
ScoreNetworkA_CC and the ablation network ScoreNetworkA_Base_CC.  Both are
a graph branch of ``AttentionLayer``s over the adjacency powers (the
kernels of ``models/attention.py``: ``gmh_attention`` unfused,
``channel_agg`` and ``gmh_scores`` fused), built by one function so that
the two cannot drift apart, beside a Hodge branch on the E × E dual of
those powers and the rank-2 tensor: ``HodgeAdjAttentionLayer``s in
ScoreNetworkA_CC, ``HodgeBaselineLayer``s in ScoreNetworkA_Base_CC.  The
final ELU MLP reads both, the Hodge channels scattered back onto the
adjacency.  As in the JAX package the fused path takes only ``fused``: f32
head scores and the concat final layer (``with_fused`` sets the fast
lowerings for ScoreNetworkA alone).  Both run in their parameters' dtype,
x, the adjacency and the rank-2 tensor cast to it, and mask the score in
its own dtype.  The JAX networks follow the rank-2 tensor's dtype instead
(score_a_cc.py:131-138, :247-251); ``follows_rank2_dtype`` says so, and
under the bf16 carry the score function runs a bf16 copy of the network
(``diffusion/losses.py get_score_fn_cc``), which computes the same.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ccsd_tpu_torch.models.attention import AttentionLayer
from ccsd_tpu_torch.models.hodge_nn import HodgeAdjAttentionLayer, HodgeBaselineLayer
from ccsd_tpu_torch.models.nn import MLP, check_no_bn, param_dtype
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.hodge import adj_to_hodgedual, hodgedual_to_adj
from ccsd_tpu_torch.ops.masks import default_mask, mask_adjs, pow_tensor


def _graph_layers(max_feat_num: int, nhid: int, num_layers: int, num_linears: int,
                  c_init: int, c_hid: int, c_final: int, adim: int, num_heads: int,
                  conv: str, fused: bool,
                  generator: Optional[torch.Generator]) -> nn.ModuleList:
    """The graph branch of both CC adjacency networks
    (ccsd_tpu/models/score_a_cc.py:25-44): channels c_init -> c_hid ->
    ... -> c_final, the first layer nhid wide, the later ones adim."""
    layers = []
    for k in range(num_layers):
        if k == 0:
            dims = (max_feat_num, nhid, nhid, c_init, c_hid)
        elif k == num_layers - 1:
            dims = (nhid, adim, nhid, c_hid, c_final)
        else:
            dims = (nhid, adim, nhid, c_hid, c_hid)
        layers.append(AttentionLayer(num_linears, *dims, num_heads, conv, fused=fused,
                                     generator=generator))
    return nn.ModuleList(layers)


def _hodge_dims(num_layers_h: int, c_init: int, c_hid_h: int, c_final_h: int,
                first_width: int, width: int) -> List[Tuple[int, int, int]]:
    """(channels in, width, channels out) of each Hodge layer: the first
    reads the c_init dual channels at ``first_width``, the later ones are
    ``width`` wide, the last writes c_final_h channels."""
    dims = []
    for k in range(num_layers_h):
        if k == 0:
            dims.append((c_init, first_width, c_hid_h))
        elif k == num_layers_h - 1:
            dims.append((c_hid_h, width, c_final_h))
        else:
            dims.append((c_hid_h, width, c_hid_h))
    return dims


class _ScoreNetworkACC(nn.Module):
    """What the two CC adjacency networks share: the graph branch, the
    final MLP and the forward.  A subclass builds ``layers_hodge`` between
    ``__init__`` and ``_final`` (the seeded init draws in that order)."""

    follows_rank2_dtype = True

    def __init__(self, max_feat_num: int, max_node_num: int, d_min: int, d_max: int,
                 nhid: int, num_layers: int, num_linears: int, c_init: int, c_hid: int,
                 c_final: int, adim: int, num_heads: int, conv: str, use_bn: bool,
                 cells, fused: bool, generator: Optional[torch.Generator]):
        super().__init__()
        check_no_bn(use_bn)
        if cells is not None:
            raise NotImplementedError(
                "an observed cell universe (cells) is not ported (ROADMAP.md, Queue A, "
                "the observed cell universe)")
        self.max_node_num, self.c_init = max_node_num, c_init
        self.spec = get_spec(max_node_num, d_min, d_max)
        self.layers = _graph_layers(max_feat_num, nhid, num_layers, num_linears, c_init,
                                    c_hid, c_final, adim, num_heads, conv, fused, generator)
        self._graph_channels = c_hid * (num_layers - 1) + c_final + c_init

    def _final(self, num_layers_h: int, c_hid_h: int, c_final_h: int,
               generator: Optional[torch.Generator]) -> None:
        self.fdim = self._graph_channels + c_hid_h * (num_layers_h - 1) + c_final_h + self.c_init
        self.final = MLP(3, self.fdim, 2 * self.fdim, 1, act="elu", generator=generator)
        self.register_buffer("mask", default_mask(self.max_node_num), persistent=False)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, rank2: torch.Tensor,
                flags: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = param_dtype(self)
        adjc = pow_tensor(adj.to(dt), self.c_init)
        hodge_adjc = adj_to_hodgedual(adjc)
        adj_list = [adjc]
        h = x.to(dt)
        for layer in self.layers:
            h, adjc = layer(h, adjc, flags)
            adj_list.append(adjc)
        hodge_list = [hodge_adjc]
        r = rank2.to(dt)
        for layer in self.layers_hodge:
            hodge_adjc, r = layer(hodge_adjc, r, flags)
            hodge_list.append(hodge_adjc)
        adj_hodge = hodgedual_to_adj(torch.cat(hodge_list, dim=1))
        feats = torch.cat(adj_list + [adj_hodge], dim=1).permute(0, 2, 3, 1)
        score = self.final(feats)[..., 0]
        return mask_adjs(score * self.mask[None].to(score.dtype), flags)


class ScoreNetworkA_CC(_ScoreNetworkACC):
    """The Hodge branch of ``HodgeAdjAttentionLayer``s (the first nhid_h
    wide, the later adim_h)."""

    def __init__(self, max_feat_num: int, max_node_num: int, d_min: int, d_max: int,
                 nhid: int, nhid_h: int, num_layers: int, num_layers_h: int,
                 num_linears: int, num_linears_h: int, c_init: int, c_hid: int,
                 c_hid_h: int, c_final: int, c_final_h: int, adim: int, adim_h: int,
                 num_heads: int = 4, num_heads_h: int = 4, conv: str = "GCN",
                 conv_hodge: str = "HCN", use_bn: bool = False, is_cc: bool = True,
                 cells=None, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(max_feat_num, max_node_num, d_min, d_max, nhid, num_layers,
                         num_linears, c_init, c_hid, c_final, adim, num_heads, conv, use_bn,
                         cells, fused, generator)
        self.layers_hodge = nn.ModuleList(
            HodgeAdjAttentionLayer(num_linears_h, *dims, self.spec, num_heads_h, conv_hodge,
                                   generator=generator)
            for dims in _hodge_dims(num_layers_h, c_init, c_hid_h, c_final_h, nhid_h, adim_h))
        self._final(num_layers_h, c_hid_h, c_final_h, generator)


class ScoreNetworkA_Base_CC(_ScoreNetworkACC):
    """The ablation network (ccsd_tpu/models/score_a_cc.py:164-273): the
    Hodge branch of ``HodgeBaselineLayer``s, whose blocks are nhid_h wide
    in the first layer and hidden_h in the later ones."""

    def __init__(self, max_feat_num: int, max_node_num: int, d_min: int, d_max: int,
                 nhid: int, nhid_h: int, num_layers: int, num_layers_h: int,
                 num_linears: int, num_linears_h: int, c_init: int, c_hid: int,
                 c_hid_h: int, c_final: int, c_final_h: int, adim: int, hidden_h: int,
                 num_heads: int = 4, conv: str = "GCN", use_bn: bool = False,
                 is_cc: bool = True, cells=None, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__(max_feat_num, max_node_num, d_min, d_max, nhid, num_layers,
                         num_linears, c_init, c_hid, c_final, adim, num_heads, conv, use_bn,
                         cells, fused, generator)
        self.layers_hodge = nn.ModuleList(
            HodgeBaselineLayer(num_linears_h, *dims, self.spec, generator=generator)
            for dims in _hodge_dims(num_layers_h, c_init, c_hid_h, c_final_h, nhid_h,
                                    hidden_h))
        self._final(num_layers_h, c_hid_h, c_final_h, generator)
