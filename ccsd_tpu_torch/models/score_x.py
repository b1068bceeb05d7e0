"""Score networks for the node-feature tensor X.

Port of ccsd_tpu/models/score_x.py:22-64 (ScoreNetworkX) and :67-150
(ScoreNetworkX_GMH: AttentionLayers over the adjacency powers, each
layer's node features kept for the final MLP).  In CC mode both take the
rank-2 tensor and ignore it, as the JAX ``apply`` does.  State-dict names
follow the reference (ccsd_tpu/utils/torch_convert.py:152-166):
``layers.{k}`` and ``final``.

Both run in their parameters' dtype: under the bf16 carry
(``sample.dtype: bf16``) the bf16 inputs are cast up to f32 parameters
where the JAX package promotes them; under bf16 scores the parameters are
bf16 already (``models/nn.py cast_copy``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccsd_tpu_torch.models.attention import AttentionLayer
from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.nn import MLP, check_no_bn, param_dtype
from ccsd_tpu_torch.ops.masks import mask_x, pow_tensor


def _final(max_feat_num: int, depth: int, nhid: int,
           generator: Optional[torch.Generator]) -> MLP:
    fdim = max_feat_num + depth * nhid
    return MLP(3, fdim, 2 * fdim, max_feat_num, act="elu", generator=generator)


class ScoreNetworkX(nn.Module):
    def __init__(self, max_feat_num: int, depth: int, nhid: int,
                 use_bn: bool = False, is_cc: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.max_feat_num, self.depth, self.nhid = max_feat_num, depth, nhid
        self.layers = nn.ModuleList(
            DenseGCNConv(max_feat_num if k == 0 else nhid, nhid,
                         generator=generator)
            for k in range(depth)
        )
        self.final = _final(max_feat_num, depth, nhid, generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor] = None,
                rank2: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = param_dtype(self)
        xs = [x.to(dt)]
        h, adj = xs[0], adj.to(dt)
        for layer in self.layers:
            h = torch.tanh(layer(h, adj))
            xs.append(h)
        out = self.final(torch.cat(xs, dim=-1))
        return mask_x(out, flags)


class ScoreNetworkX_GMH(nn.Module):
    """GMH attention over the adjacency powers (channels c_init -> c_hid ->
    ... -> c_final; the first layer nhid wide, the later ones adim), each
    layer's node features through tanh into the final MLP.  ``fused``,
    ``scores_impl`` and ``agg_impl`` pick the AttentionLayer path, as in
    ScoreNetworkA; the parameters are the same under every setting."""

    def __init__(self, max_feat_num: int, depth: int, nhid: int, num_linears: int,
                 c_init: int, c_hid: int, c_final: int, adim: int, num_heads: int = 4,
                 conv: str = "GCN", use_bn: bool = False, is_cc: bool = False,
                 fused: bool = False, scores_impl: str = "mulreduce",
                 agg_impl: str = "mulreduce",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.max_feat_num, self.depth, self.nhid, self.c_init = (
            max_feat_num, depth, nhid, c_init)
        layers = []
        for k in range(depth):  # first / last / middle shapes: score_x.py:92-124
            if k == 0:
                dims = (max_feat_num, nhid, nhid, c_init, c_hid)
            elif k == depth - 1:
                dims = (nhid, adim, nhid, c_hid, c_final)
            else:
                dims = (nhid, adim, nhid, c_hid, c_hid)
            layers.append(AttentionLayer(num_linears, *dims, num_heads, conv,
                                         fused=fused, scores_impl=scores_impl,
                                         agg_impl=agg_impl, generator=generator))
        self.layers = nn.ModuleList(layers)
        self.final = _final(max_feat_num, depth, nhid, generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor] = None,
                rank2: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = param_dtype(self)
        x, adj = x.to(dt), adj.to(dt)
        adjc = pow_tensor(adj, self.c_init)
        xs = [x]
        h = x
        for layer in self.layers:
            h, adjc = layer(h, adjc, flags)
            h = torch.tanh(h)
            xs.append(h)
        out = self.final(torch.cat(xs, dim=-1))
        return mask_x(out, flags)
