"""Graph multi-head (GMH) attention over adjacency channels.

Port of ccsd_tpu/models/attention.py:24-93 (Attention) and :96-332
(AttentionLayer, both paths).  Unfused, with ``conv="GCN"`` the whole
attention of every channel of a layer is one call of
``kernels.gmh_attention`` (one CUDA launch on the card); ``conv="MLP"``
stays plain PyTorch.  Fused (``fused=True``, the port of
``_fused_attention`` :205-332), the channels are folded into stacked
contractions: the aggregation is one ``kernels.channel_agg`` call and the
head scores one ``kernels.gmh_scores`` call per layer, with the per-channel
weight products left to cuBLAS, as the JAX package leaves them to XLA.

In bf16 (the bf16 sampling modes) the kernels take bf16 tensors and the
layer follows the JAX layer's dtypes: mixed operands are promoted to f32,
and the fused path's head scores leave an f32 map except under
``scores_impl="mulreduce"`` (ccsd_tpu/models/attention.py:306-326: the
other lowerings take tanh in f32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ccsd_tpu_torch.kernels.channel_agg import channel_agg
from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, head_split
from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, round_bf16
from ccsd_tpu_torch.models.gcn import DenseGCNConv
from ccsd_tpu_torch.models.nn import MLP, check_no_bn, promoted
from ccsd_tpu_torch.ops.masks import mask_adjs, mask_x

# fused-path lowering names of the JAX package (attention.py:113-119) and
# what each means here: the scores' product type is bf16 or f32, and
# "dot_bf16" aggregation rounds its inputs and output to bf16
SCORES_BF16 = {"mulreduce": False, "mulreduce_h": False, "dot": False,
               "mulreduce_h_bf16": True, "dot_bf16": True}
AGG_IMPLS = ("mulreduce", "dot", "dot_bf16")


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
            x, adj, *w = promoted(x, adj, q.weight, q.bias, k.weight, k.bias, v.weight,
                                  v.bias)
            V, A = gmh_attention(x, adj[:, None].contiguous(), *(t[None] for t in w),
                                 self.num_heads, self.out_dim)
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
                 fused: bool = False, scores_impl: str = "mulreduce",
                 agg_impl: str = "mulreduce",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_no_bn(use_bn)
        if scores_impl not in SCORES_BF16 or agg_impl not in AGG_IMPLS:
            raise ValueError(f"unknown fused lowering scores_impl={scores_impl!r}, "
                             f"agg_impl={agg_impl!r}")
        self.input_dim, self.output_dim = input_dim, output_dim
        self.conv_output_dim, self.num_heads, self.conv = conv_output_dim, num_heads, conv
        self.fused, self.scores_impl, self.agg_impl = fused, scores_impl, agg_impl
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
        """The channels' attention weights stacked on a leading C, in the form
        this layer's path takes them (``_stack_weights``).

        Without autograd the stacks are cached until a parameter changes
        (tracked by storage and version), so the sampler's loop does not
        re-stack the weights at every evaluation.
        """
        key = tuple((p.data_ptr(), p._version) for p in self.attn.parameters())
        if torch.is_grad_enabled() or key != self._stack_key:
            stack = self._stack_weights()
            if torch.is_grad_enabled():
                return stack
            self._stack_key, self._stack = key, stack
        return self._stack

    def _stack_weights(self):
        def st(get):
            return torch.stack([get(a) for a in self.attn])

        def lin(m, i):  # layer i of MLP m as (weight (in, out), bias (1, out))
            return (st(lambda a: getattr(a, m).linears[i].weight.T),
                    st(lambda a: getattr(a, m).linears[i].bias)[:, None])

        v = (st(lambda a: a.gnn_v.weight), st(lambda a: a.gnn_v.bias))
        if self.conv == "MLP":  # fused only: (W1, b1) of q | k, (W2, b2) of q, k; v
            (wq1, bq1), (wk1, bk1) = lin("gnn_q", 0), lin("gnn_k", 0)
            return (torch.cat([wq1, wk1], -1), torch.cat([bq1, bk1], -1),
                    *lin("gnn_q", 1), *lin("gnn_k", 1), v[0], v[1][:, None])
        q = (st(lambda a: a.gnn_q.weight), st(lambda a: a.gnn_q.bias))
        k = (st(lambda a: a.gnn_k.weight), st(lambda a: a.gnn_k.bias))
        if not self.fused:  # wq, bq, wk, bk, wv, bv
            return (*q, *k, *v)
        # [Wq | Wk | Wv] (C, F_in, 2A + O) and its bias (C, 1, 2A + O)
        return (torch.cat([q[0], k[0], v[0]], -1),
                torch.cat([q[1], k[1], v[1]], -1)[:, None])

    def _fused_attention(self, x: torch.Tensor, adj: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All C_i attentions as stacked contractions (attention.py:205-332):
        x (B, N, F_i), adj (B, C_i, N, N) -> (V (B, N, C_i * O), maps
        (B, N, N, C_i)).  The aggregation is ``(norm @ x) @ W``, norm formed
        inside ``channel_agg``."""
        B, N, _ = x.shape
        C, A, O = self.input_dim, self.attn[0].attn_dim, self.conv_output_dim
        # the kernel normalises adj itself and reads it through its strides:
        # the channels-last view the previous layer's MLP leaves needs no copy
        x_in = x  # the MLP convs read the layer's x as it came
        adj, x = promoted(adj, x.contiguous())
        nx = channel_agg(adj, x, bf16=self.agg_impl == "dot_bf16")  # (B, C, N, F_i)
        if self.agg_impl == "dot_bf16" and nx.dtype == torch.float32:
            nx = round_bf16(nx)
        if self.conv == "GCN":
            w, b = self._stacked()
            # per-channel (norm @ x) @ [Wq | Wk | Wv] + bias, one batched
            # product over C: (C, B*N, F_i) @ (C, F_i, 2A + O)
            b, nx, w = promoted(b, nx, w)
            qkv = torch.baddbmm(b, nx.transpose(0, 1).reshape(C, B * N, -1), w)
            qkv = qkv.view(C, B, N, -1).transpose(0, 1)  # (B, C, N, 2A + O) view
            q, k, v = qkv[..., :A], qkv[..., A:2 * A], qkv[..., 2 * A:]
        else:  # Q, K: 2-layer tanh MLPs of x; V stays a GCN conv
            w1, b1, wq, bq, wk, bk, wv, bv = self._stacked()
            hid = wq.shape[1]
            h1 = torch.tanh(torch.einsum("bnf,cfh->bcnh", *promoted(x_in, w1)) + b1)
            q = torch.einsum("bcnh,chp->bcnp", *promoted(h1[..., :hid], wq)) + bq
            k = torch.einsum("bcnh,chp->bcnp", *promoted(h1[..., hid:], wk)) + bk
            v = torch.einsum("bcnf,cfo->bcno", *promoted(nx, wv)) + bv
            q, k = promoted(q, k)
        att = gmh_scores(q, k, self.num_heads, O, bf16=SCORES_BF16[self.scores_impl])
        if self.scores_impl != "mulreduce":
            att = att.float()
        return v.transpose(1, 2).reshape(B, N, C * O), att

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                flags: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, N, F_i), adj: (B, C_i, N, N) -> ((B, N, F_o), (B, C_o, N, N))."""
        if self.fused:
            v, att = self._fused_attention(x, adj)
        elif self.conv == "GCN":
            # the kernel reads adj through its strides: the channels-last
            # view the previous layer's MLP leaves needs no copy
            x_, adj_, *w = promoted(x.contiguous(), adj, *self._stacked())
            v, att = gmh_attention(x_, adj_, *w, self.num_heads, self.conv_output_dim)
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
