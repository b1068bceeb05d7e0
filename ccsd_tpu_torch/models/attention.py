"""Graph multi-head (GMH) attention over adjacency channels.

Port of ccsd_tpu/models/attention.py:24-93 (Attention) and the unfused path
of :165-203 (AttentionLayer).  With ``conv="GCN"`` the whole attention of
every channel of a layer is one call of ``kernels.gmh_attention`` (one CUDA
launch on the card); ``conv="MLP"`` stays plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, head_split
from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.nn import MLP, check_no_bn
from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x


class Attention(nn.Module):
    """Single GMH attention: returns (value, symmetrised attention map)."""

    def __init__(self, in_dim: int, attn_dim: int, out_dim: int,
                 num_heads: int = 4, conv: str = "GCN",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_dim, self.attn_dim, self.out_dim = in_dim, attn_dim, out_dim
        self.num_heads, self.conv = num_heads, conv
        head_split(attn_dim, num_heads)
        g = generator
        if conv == "GCN":
            self.gnn_q = DenseGCNConv(in_dim, attn_dim, generator=g)
            self.gnn_k = DenseGCNConv(in_dim, attn_dim, generator=g)
        elif conv == "MLP":
            self.gnn_q = MLP(2, in_dim, 2 * attn_dim, attn_dim, act="tanh", generator=g)
            self.gnn_k = MLP(2, in_dim, 2 * attn_dim, attn_dim, act="tanh", generator=g)
        else:
            raise NotImplementedError(f"Convolution layer {conv} not implemented.")
        self.gnn_v = DenseGCNConv(in_dim, out_dim, generator=g)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, N, F_in), adj: (B, N, N) -> (V (B, N, F_out), A (B, N, N))."""
        if self.conv == "GCN":
            q, k, v = self.gnn_q, self.gnn_k, self.gnn_v
            V, A = gmh_attention(
                x, adj[:, None].contiguous(), q.weight[None], q.bias[None],
                k.weight[None], k.bias[None], v.weight[None], v.bias[None],
                self.num_heads, self.out_dim,
            )
            return V, A[..., 0]
        Q, K = self.gnn_q(x), self.gnn_k(x)
        V = self.gnn_v(x, adj)
        B, N, _ = Q.shape
        H, ds = head_split(self.attn_dim, self.num_heads)
        Qh = Q.reshape(B, N, H, ds)
        Kh = K.reshape(B, N, H, ds)
        s = torch.einsum("bnhd,bmhd->hbnm", Qh, Kh) / math.sqrt(self.out_dim)
        A = torch.tanh(s).mean(dim=0)
        return V, (A + A.transpose(-1, -2)) / 2


class AttentionLayer(nn.Module):
    """Per-channel GMH attention plus node and edge MLP heads."""

    def __init__(self, num_linears: int, conv_input_dim: int, attn_dim: int,
                 conv_output_dim: int, input_dim: int, output_dim: int,
                 num_heads: int = 4, conv: str = "GCN", use_bn: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.conv_output_dim, self.num_heads, self.conv = conv_output_dim, num_heads, conv
        self.attn = nn.ModuleList(
            Attention(conv_input_dim, attn_dim, conv_output_dim, num_heads, conv,
                      generator=generator)
            for _ in range(input_dim)
        )
        hidden = 2 * max(input_dim, output_dim)
        self.mlp = MLP(num_linears, 2 * input_dim, hidden, output_dim, act="elu",
                       generator=generator)
        self.multi_channel = MLP(2, input_dim * conv_output_dim, hidden,
                                 conv_output_dim, act="elu", generator=generator)
        self._stack_key = None
        self._stack = None

    def _stacked(self):
        """(wq, bq, wk, bk, wv, bv) of all channels, stacked on a leading C.

        Without autograd the stacks are cached until a parameter changes
        (tracked by storage and version), so the sampler's loop does not
        re-stack the weights at every evaluation.
        """
        params = [p for a in self.attn for p in (
            a.gnn_q.weight, a.gnn_q.bias, a.gnn_k.weight, a.gnn_k.bias,
            a.gnn_v.weight, a.gnn_v.bias)]
        key = tuple((p.data_ptr(), p._version) for p in params)
        if torch.is_grad_enabled() or key != self._stack_key:
            stack = tuple(torch.stack(params[i::6]) for i in range(6))
            if torch.is_grad_enabled():
                return stack
            self._stack_key, self._stack = key, stack
        return self._stack

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, N, F_i), adj: (B, C_i, N, N) -> ((B, N, F_o), (B, C_o, N, N))."""
        if self.conv == "GCN":
            # the previous layer's channels-last MLP leaves adj strided
            v, att = gmh_attention(x.contiguous(), adj.contiguous(),
                                   *self._stacked(), self.num_heads,
                                   self.conv_output_dim)
        else:
            outs = [a(x, adj[:, k]) for k, a in enumerate(self.attn)]
            v = torch.cat([o[0] for o in outs], dim=-1)
            att = torch.stack([o[1] for o in outs], dim=-1)  # (B, N, N, C_i)
        x_out = torch.tanh(mask_x(self.multi_channel(v), flags))

        # channels-last concat of [attention maps | input adjacency channels]
        mlp_in = torch.cat([att, adj.permute(0, 2, 3, 1)], dim=-1)
        adj_out = self.mlp(mlp_in).permute(0, 3, 1, 2)
        adj_out = adj_out + adj_out.transpose(-1, -2)
        return x_out, mask_adjs(adj_out, flags)
