"""Score network for the rank-2 incidence tensor F.

Port of the unfused ScoreNetworkF (ccsd_tpu/models/score_f.py:50-130): the
channel stack [F, HF, H²F, ...] (H = F Fᵀ, its diagonal masked out with
``use_hodge_mask``), a stack of ``HodgeNetworkLayer`` channel MLPs, and a
final ELU MLP over every layer's channels.  The slab-unrolled fused form
(:132-177, the same numerics) is not ported, so ``fused`` is refused.
The score depends on the rank-2 tensor only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccsd_tpu_torch.models.hodge_nn import HodgeNetworkLayer
from ccsd_tpu_torch.models.nn import MLP, check_no_bn
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.hodge import hodgedual_mask_from_spec, pow_tensor_cc
from ccsd_tpu_torch.ops.masks import mask_rank2


class ScoreNetworkF(nn.Module):
    def __init__(self, num_layers_mlp: int, num_layers: int, num_linears: int, nhid: int,
                 c_hid: int, c_final: int, cnum: int, max_node_num: int, d_min: int,
                 d_max: int, use_hodge_mask: bool = True, use_bn: bool = False,
                 is_cc: bool = True, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        if fused:
            raise NotImplementedError("the slab-unrolled ScoreNetworkF (fused) is not ported")
        self.cnum = cnum
        self.spec = spec = get_spec(max_node_num, d_min, d_max)
        layers = []
        for k in range(num_layers):
            cin = cnum if k == 0 else c_hid
            cout = c_final if k == num_layers - 1 else c_hid
            layers.append(HodgeNetworkLayer(num_linears, cin, nhid, cout, spec,
                                            generator=generator))
        self.layers = nn.ModuleList(layers)
        self.fdim = c_hid * (num_layers - 1) + c_final + cnum
        self.final = MLP(num_layers_mlp, self.fdim, 2 * self.fdim, 1, act="elu",
                         generator=generator)
        if use_hodge_mask:
            self.register_buffer("hodge_mask", hodgedual_mask_from_spec(spec),
                                 persistent=False)
        else:
            self.hodge_mask = None

    def forward(self, x: torch.Tensor, adj: torch.Tensor, rank2: torch.Tensor,
                flags: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = pow_tensor_cc(rank2, self.cnum, self.hodge_mask)
        feats = [h]
        for layer in self.layers:
            h = layer(h, flags)
            feats.append(h)
        score = self.final(torch.cat(feats, dim=1).movedim(1, -1))[..., 0]
        return mask_rank2(score, self.spec, flags)
