"""Score network for the node-feature tensor X.

Port of ccsd_tpu/models/score_x.py:22-64 (ScoreNetworkX).  In CC mode it
takes the rank-2 tensor and ignores it, as the JAX ``apply`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.nn import MLP, check_no_bn
from ccsd_tpu_torch.ops.masks import mask_x


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
        fdim = max_feat_num + depth * nhid
        self.final = MLP(3, fdim, 2 * fdim, max_feat_num, act="elu",
                         generator=generator)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor] = None,
                rank2: Optional[torch.Tensor] = None) -> torch.Tensor:
        xs = [x]
        h = x
        for layer in self.layers:
            h = torch.tanh(layer(h, adj))
            xs.append(h)
        out = self.final(torch.cat(xs, dim=-1))
        return mask_x(out, flags)
