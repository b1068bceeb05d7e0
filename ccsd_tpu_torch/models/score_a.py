"""Score network for the adjacency tensor A (graph mode).

Port of ccsd_tpu/models/score_a.py:104-217 (``_a_layers`` and
ScoreNetworkA).  ``fused``, ``scores_impl`` and ``agg_impl`` pick the
AttentionLayer path (models/attention.py); ``final_impl`` the first layer of
the final MLP: ``"concat"`` applies it to the channels-last concat of every
layer's adjacency channels, ``"blocksum"`` applies the matching weight slice
to each block and sums (score_a.py:194-212; the same function, without the
concat).  The parameters are the same under every setting.  ``is_cc``
(the two-stage model's graph ScoreNetworkA) changes nothing: the score
depends on x and the adjacency only.  The network runs in its parameters'
dtype (``ScoreNetworkX``'s rule, models/score_x.py); its score leaves in
f32 wherever the f32 ``default_mask`` meets it, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccsd_tpu_torch.models.attention import AttentionLayer
from ccsd_tpu_torch.models.nn import MLP, apply_linear, check_no_bn, param_dtype, promoted
from ccsd_tpu_torch.ops.masks import default_mask, mask_adjs, pow_tensor


class ScoreNetworkA(nn.Module):
    def __init__(self, max_feat_num: int, max_node_num: int, nhid: int,
                 num_layers: int, num_linears: int, c_init: int, c_hid: int,
                 c_final: int, adim: int, num_heads: int = 4, conv: str = "GCN",
                 use_bn: bool = False, is_cc: bool = False, fused: bool = False,
                 scores_impl: str = "mulreduce", agg_impl: str = "mulreduce",
                 final_impl: str = "concat",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        if final_impl not in ("concat", "blocksum"):
            raise ValueError(f"unknown final_impl {final_impl!r}")
        self.max_node_num, self.c_init, self.final_impl = max_node_num, c_init, final_impl
        layers = []
        for k in range(num_layers):
            if k == 0:  # first / last / middle shapes: score_a.py:112-130
                dims = (max_feat_num, nhid, nhid, c_init, c_hid)
            elif k == num_layers - 1:
                dims = (nhid, adim, nhid, c_hid, c_final)
            else:
                dims = (nhid, adim, nhid, c_hid, c_hid)
            layers.append(AttentionLayer(num_linears, *dims, num_heads, conv,
                                         fused=fused, scores_impl=scores_impl,
                                         agg_impl=agg_impl, generator=generator))
        self.layers = nn.ModuleList(layers)
        self.fdim = c_hid * (num_layers - 1) + c_final + c_init
        self.final = MLP(3, self.fdim, 2 * self.fdim, 1, act="elu",
                         generator=generator)
        self.register_buffer("mask", default_mask(max_node_num), persistent=False)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = param_dtype(self)
        adjc = pow_tensor(adj.to(dt), self.c_init)
        adj_list = [adjc]
        h = x.to(dt)
        for layer in self.layers:
            h, adjc = layer(h, adjc, flags)
            adj_list.append(adjc)
        if self.final_impl == "blocksum":
            first, rest = self.final.linears[0], self.final.linears[1:]
            h, off = first.bias, 0
            for blk in adj_list:
                c = blk.shape[1]
                h = h + torch.einsum("bcnm,hc->bnmh",
                                     *promoted(blk, first.weight[:, off:off + c]))
                off += c
            for lin in rest:
                h = apply_linear(lin, self.final.act(h))
            score = h[..., 0]
        else:
            adjs = torch.cat(adj_list, dim=1).permute(0, 2, 3, 1)
            score = self.final(adjs)[..., 0]
        return mask_adjs(score * self.mask[None], flags)
