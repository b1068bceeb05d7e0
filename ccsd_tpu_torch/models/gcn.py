"""Dense GCN convolution on padded adjacency batches.

Port of ccsd_tpu/models/gcn.py:23-67.  The weight is stored (in, out) as in
the reference, so weights copy across unchanged; the aggregation runs
through ``kernels.gcn.gcn_aggregate`` (the CUDA kernel on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ccsd_tpu_torch.kernels.gcn import gcn_aggregate, gcn_norm  # noqa: F401
from ccsd_tpu_torch.models.nn import glorot_, promoted


class DenseGCNConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 improved: bool = False, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.improved = improved
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels))
        glorot_(self.weight, in_channels, out_channels, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    @property
    def loop(self) -> float:
        return 2.0 if self.improved else 1.0

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                add_loop: bool = True) -> torch.Tensor:
        """x: (B, N, F_in), adj: (B, N, N) -> (B, N, F_out), in the promoted
        dtype of the inputs and parameters.  The kernel takes contiguous
        tensors: a channel of a layer's (B, C, N, N) adjacency (the
        MLP-conv attention's value conv) is copied, a contiguous one is
        not."""
        x, adj, w, b = promoted(x, adj, self.weight, self.bias)
        out = gcn_aggregate(x.contiguous(), adj.contiguous(), w, b, self.loop, add_loop)
        if mask is not None:
            out = out * mask[..., :, None].to(x.dtype)
        return out
