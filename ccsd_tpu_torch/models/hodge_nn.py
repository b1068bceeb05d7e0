"""Hodge-domain layers: the HCN convolution and HCCMH attention on the
E × E dual, the ablation network's baseline layers, and the channel MLP
over rank-2 channels.

Port of ccsd_tpu/models/hodge_nn.py:23-308 (``HodgeNetworkLayer``,
``DenseHCNConv``, ``HodgeAttention``, ``HodgeAdjAttentionLayer``,
``BaselineBlock``, ``HodgeBaselineLayer``).  Plain PyTorch: the JAX package
computes these in plain ``jnp``, outside any Pallas kernel, and their
E × E × K products are ``torch.bmm``.  State-dict names follow the
reference (ccsd_tpu/utils/torch_convert.py:116-149): ``ccnn_q``/``ccnn_k``
of an attention, ``attn.{i}``, ``mlp_value`` and ``mlp_attention`` of a
layer, ``layers.{i}.mlp_layer``, ``mlp_rank2`` and ``mlp_hodge`` of a
baseline layer, ``layer`` of a network layer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ccsd_tpu_torch.kernels.gmh_attention import head_split
from ccsd_tpu_torch.models.nn import MLP, check_no_bn, glorot_
from ccsd_tpu_torch.ops.cells import ComplexSpec
from ccsd_tpu_torch.ops.masks import mask_hodge_adjs, mask_rank2


class HodgeNetworkLayer(nn.Module):
    """Channels-last ELU MLP over rank-2 channels: (B, C_i, E, K) ->
    (B, C_o, E, K), masked."""

    def __init__(self, num_linears: int, input_dim: int, nhid: int, output_dim: int,
                 spec: ComplexSpec, use_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.spec = spec
        self.layer = MLP(num_linears, input_dim, nhid, output_dim, act="elu",
                         generator=generator)

    def forward(self, rank2: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.layer(rank2.movedim(1, -1)).movedim(-1, 1)
        return mask_rank2(h, self.spec, flags)


class DenseHCNConv(nn.Module):
    """Hodge convolution: D^-½ H D^-½ (F W) + b, D the row sums of the E × E
    dual clipped below at 1, with no self-loop (not ``gcn_norm``: the GCN
    kernels add the loop and assign the diagonal).  The weight is stored
    (in, out), as in the reference."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels))
        glorot_(self.weight, in_channels, out_channels, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, hodge_adj: torch.Tensor, rank2: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """hodge_adj: (B, E, E), rank2: (B, E, K_in) -> (B, E, out)."""
        out = rank2 @ self.weight
        d = hodge_adj.sum(-1).clamp(min=1.0).pow(-0.5)
        norm = d[..., :, None] * hodge_adj * d[..., None, :]
        out = torch.bmm(norm, out)
        if self.bias is not None:
            out = out + self.bias
        if mask is not None:
            out = out * mask[..., :, None].to(out.dtype)
        return out


class HodgeAttention(nn.Module):
    """HCCMH attention on the Hodge dual: Q, K from HCN convolutions (or
    tanh MLPs) of the rank-2 tensor, scores divided by √out_dim (out_dim =
    K, the cell count, not the head width), V = H F with no convolution.
    Returns (V (B, E, K), sym(mean_h tanh(Q_h K_hᵀ / √K)) (B, E, E))."""

    def __init__(self, in_dim: int, attn_dim: int, out_dim: int, num_heads: int = 4,
                 conv: str = "HCN", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attn_dim, self.out_dim, self.num_heads, self.conv = (
            attn_dim, out_dim, num_heads, conv)
        head_split(attn_dim, num_heads)
        g = generator
        if conv == "HCN":
            self.ccnn_q = DenseHCNConv(in_dim, attn_dim, generator=g)
            self.ccnn_k = DenseHCNConv(in_dim, attn_dim, generator=g)
        elif conv == "MLP":
            self.ccnn_q = MLP(2, in_dim, 2 * attn_dim, attn_dim, act="tanh", generator=g)
            self.ccnn_k = MLP(2, in_dim, 2 * attn_dim, attn_dim, act="tanh", generator=g)
        else:
            raise NotImplementedError(f"Convolution layer {conv} not implemented.")

    def forward(self, hodge_adj: torch.Tensor, rank2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.conv == "HCN":
            Q, K = self.ccnn_q(hodge_adj, rank2), self.ccnn_k(hodge_adj, rank2)
        else:  # as the JAX package: the MLPs read the dual itself
            Q, K = self.ccnn_q(hodge_adj), self.ccnn_k(hodge_adj)
        V = torch.bmm(hodge_adj, rank2)
        B, E, _ = Q.shape
        H, ds = head_split(self.attn_dim, self.num_heads)
        s = torch.einsum("bnhd,bmhd->hbnm", Q.reshape(B, E, H, ds),
                         K.reshape(B, E, H, ds)) / math.sqrt(self.out_dim)
        A = torch.tanh(s).mean(dim=0)
        return V, (A + A.transpose(-1, -2)) / 2


class HodgeAdjAttentionLayer(nn.Module):
    """One HodgeAttention per input channel (each its own parameters), then
    ELU MLP heads: ``mlp_attention`` over the channels of the attention maps
    (-> the next dual channels, tanh, symmetrised) and ``mlp_value`` over
    the channels of the values (-> the next rank-2 tensor)."""

    def __init__(self, num_linears: int, input_dim: int, attn_dim: int,
                 conv_output_dim: int, spec: ComplexSpec, num_heads: int = 4,
                 conv: str = "HCN", use_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.spec = spec
        K = spec.num_cells
        self.attn = nn.ModuleList(
            HodgeAttention(K, attn_dim, K, num_heads, conv, generator=generator)
            for _ in range(input_dim))
        hidden = 2 * max(input_dim, conv_output_dim)
        self.mlp_value = MLP(num_linears, input_dim, hidden, 1, act="elu",
                             generator=generator)
        self.mlp_attention = MLP(num_linears, input_dim, hidden, conv_output_dim,
                                 act="elu", generator=generator)

    def forward(self, hodge_adj: torch.Tensor, rank2: torch.Tensor,
                flags: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """hodge_adj: (B, C_i, E, E), rank2: (B, E, K) ->
        ((B, C_o, E, E), (B, E, K))."""
        outs = [a(hodge_adj[:, k], rank2) for k, a in enumerate(self.attn)]
        h = self.mlp_attention(torch.stack([o[1] for o in outs], -1)).movedim(-1, 1)
        h = torch.tanh(mask_hodge_adjs(h, self.spec, flags))
        r = self.mlp_value(torch.stack([o[0] for o in outs], -1))[..., 0]
        return h + h.transpose(-1, -2), mask_rank2(r, self.spec, flags)


class BaselineBlock(nn.Module):
    """An ELU MLP of two layers over the rows of one E × E dual channel H,
    then h = tanh(MLP(H)): returns (h F (B, E, K), (h + hᵀ) / 2 (B, E, E))."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp_layer = MLP(2, in_dim, hidden_dim, out_dim, act="elu", generator=generator)

    def forward(self, hodge_adj: torch.Tensor, rank2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.tanh(self.mlp_layer(hodge_adj))
        return torch.bmm(h, rank2), (h + h.transpose(-1, -2)) / 2


class HodgeBaselineLayer(nn.Module):
    """The ablation network's Hodge layer: one BaselineBlock per input
    channel (each its own parameters, hidden width ``hidden_dim``), then ELU
    MLP heads over the channels: ``mlp_hodge`` over the blocks' symmetrised
    maps (-> the next dual channels, masked, tanh, h + hᵀ) and
    ``mlp_rank2`` over their products with F (-> the next rank-2 tensor)."""

    def __init__(self, num_linears: int, input_dim: int, hidden_dim: int,
                 conv_output_dim: int, spec: ComplexSpec, use_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.spec = spec
        E = spec.num_edges
        self.layers = nn.ModuleList(
            BaselineBlock(E, hidden_dim, E, generator=generator) for _ in range(input_dim))
        hidden = 2 * max(input_dim, conv_output_dim)
        self.mlp_rank2 = MLP(num_linears, input_dim, hidden, 1, act="elu",
                             generator=generator)
        self.mlp_hodge = MLP(num_linears, input_dim, hidden, conv_output_dim,
                             act="elu", generator=generator)

    def forward(self, hodge_adj: torch.Tensor, rank2: torch.Tensor,
                flags: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """hodge_adj: (B, C_i, E, E), rank2: (B, E, K) ->
        ((B, C_o, E, E), (B, E, K))."""
        outs = [b(hodge_adj[:, k], rank2) for k, b in enumerate(self.layers)]
        h = self.mlp_hodge(torch.stack([o[1] for o in outs], -1)).movedim(-1, 1)
        h = torch.tanh(mask_hodge_adjs(h, self.spec, flags))
        r = self.mlp_rank2(torch.stack([o[0] for o in outs], -1))[..., 0]
        return h + h.transpose(-1, -2), mask_rank2(r, self.spec, flags)
