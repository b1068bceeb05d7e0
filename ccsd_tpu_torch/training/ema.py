"""Exponential moving average of a network's parameters.

Port of ccsd_tpu/training/ema.py:17-45: after each optimizer step,
``shadow -= (1 - decay_t) (shadow - param)`` with the warmup
``decay_t = min(decay, (1 + n) / (10 + n))`` at update n, taken in float32
as the JAX package takes it.  ``copy_to`` puts the shadow into a network
for evaluation (the reference's ``copy_to``).  The state dict is the
reference's layout: ``{decay, num_updates, shadow_params}``, the shadows
in ``parameters()`` order.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn


class EMA:
    def __init__(self, model: nn.Module, decay: float = 0.999):
        if not 0.0 <= decay <= 1.0:
            raise ValueError("Decay must be between 0 and 1")
        self.decay = float(decay)
        self.num_updates = 0
        self.shadow_params: List[torch.Tensor] = [
            p.detach().clone() for p in model.parameters()]

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.num_updates += 1
        n = np.float32(self.num_updates)
        decay = min(np.float32(self.decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))
        one_minus = float(np.float32(1.0) - decay)
        diff = torch._foreach_sub(self.shadow_params, [p.detach() for p in model.parameters()])
        torch._foreach_mul_(diff, one_minus)
        torch._foreach_sub_(self.shadow_params, diff)

    @torch.no_grad()
    def copy_to(self, model: nn.Module) -> nn.Module:
        torch._foreach_copy_(list(model.parameters()), self.shadow_params)
        return model

    def state_dict(self) -> dict:
        return {"decay": self.decay, "num_updates": self.num_updates,
                "shadow_params": list(self.shadow_params)}

    def load_state_dict(self, state: dict) -> None:
        self.decay = float(state["decay"])
        self.num_updates = int(state["num_updates"])
        with torch.no_grad():
            torch._foreach_copy_(self.shadow_params, list(state["shadow_params"]))
