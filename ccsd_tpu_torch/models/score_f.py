"""Score network for the rank-2 incidence tensor F.

Port of ScoreNetworkF (ccsd_tpu/models/score_f.py:21-177): the channel
stack [F, HF, H²F, ...] (H = F Fᵀ, its diagonal masked out with
``use_hodge_mask``), a stack of ``HodgeNetworkLayer`` channel MLPs, and a
final ELU MLP over every layer's channels.  ``fused`` picks the
slab-unrolled form of the same function with the same parameters
(``_apply_fused``, :132-177): the channel axis is a list of (B, E, K)
slabs and each channel Linear a sum of scalar-weight multiply-adds, so no
(B, C, E, K) tensor or channels-last copy is formed.  A per-sample
candidate-cell universe (``dyn=(member, valid)``, the two-stage model's
stage 2) goes through the slab form only, as in the JAX package
(:109-112), masked by ``mask_rank2_dynamic``.  The score depends on the
rank-2 tensor only.  The slab form runs in its parameters' dtype, the
rank-2 tensor and the Hodge mask cast to it; the JAX one follows the
rank-2 tensor's dtype instead (:149-155), so ``follows_rank2_dtype`` is
set for it and the score function runs a bf16 copy under the bf16 carry
(``diffusion/losses.py get_score_fn_cc``).  The channel-stack form keeps
its parameters and promotes a bf16 rank-2 tensor, as JAX's does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ccsd_tpu_torch.models.hodge_nn import HodgeNetworkLayer
from ccsd_tpu_torch.models.nn import MLP, check_no_bn, param_dtype
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.hodge import hodge_laplacian, hodgedual_mask_from_spec, pow_tensor_cc
from ccsd_tpu_torch.ops.masks import mask_rank2, mask_rank2_dynamic


def linear_slabs(lin: nn.Linear, slabs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A channel Linear over a list of (B, E, K) slabs, unrolled into
    scalar-weight multiply-adds in the JAX package's order
    (ccsd_tpu/models/score_f.py:21-31)."""
    w, b = lin.weight, lin.bias  # w: (out, in)
    outs = []
    for o in range(w.shape[0]):
        acc = b[o]
        for c, s in enumerate(slabs):
            acc = acc + w[o, c] * s
        outs.append(acc)
    return outs


def mlp_slabs(mlp: MLP, slabs: List[torch.Tensor]) -> List[torch.Tensor]:
    """An MLP over channel slabs (see ``linear_slabs``)."""
    lins = [mlp.linear] if mlp.num_layers == 1 else list(mlp.linears)
    h = slabs
    for i, lin in enumerate(lins):
        h = linear_slabs(lin, h)
        if i < len(lins) - 1:
            h = [mlp.act(s) for s in h]
    return h


class ScoreNetworkF(nn.Module):
    def __init__(self, num_layers_mlp: int, num_layers: int, num_linears: int, nhid: int,
                 c_hid: int, c_final: int, cnum: int, max_node_num: int, d_min: int,
                 d_max: int, use_hodge_mask: bool = True, use_bn: bool = False,
                 is_cc: bool = True, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.cnum, self.fused = cnum, fused
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

    @property
    def follows_rank2_dtype(self) -> bool:
        """The slab form follows the rank-2 tensor's dtype in the JAX package."""
        return self.fused

    def forward(self, x: Optional[torch.Tensor], adj: Optional[torch.Tensor],
                rank2: torch.Tensor, flags: Optional[torch.Tensor] = None,
                dyn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        if dyn is not None or self.fused:
            return self._apply_fused(rank2.to(param_dtype(self)), flags, dyn)
        h = pow_tensor_cc(rank2, self.cnum, self.hodge_mask)
        feats = [h]
        for layer in self.layers:
            h = layer(h, flags)
            feats.append(h)
        score = self.final(torch.cat(feats, dim=1).movedim(1, -1))[..., 0]
        return mask_rank2(score, self.spec, flags)

    def _apply_fused(self, rank2: torch.Tensor, flags: Optional[torch.Tensor],
                     dyn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """The slab-unrolled network (ccsd_tpu/models/score_f.py:132-176),
        over the spec's universe or, with ``dyn = (member, valid)``, over a
        per-sample one."""
        spec = self.spec
        if dyn is not None:
            member, valid = dyn

            def mask(s):
                return mask_rank2_dynamic(s, spec, member, valid, flags)
        else:
            def mask(s):
                return mask_rank2(s, spec, flags)

        H = hodge_laplacian(rank2)
        if self.hodge_mask is not None:
            H = H * self.hodge_mask[None].to(H.dtype)
        slabs = [rank2]
        for _ in range(self.cnum - 1):
            slabs.append(torch.bmm(H, slabs[-1]))
        feats = list(slabs)
        h = slabs
        for layer in self.layers:
            h = [mask(s) for s in mlp_slabs(layer.layer, h)]
            feats.extend(h)
        return mask(mlp_slabs(self.final, feats)[0])
