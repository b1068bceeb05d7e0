"""The optimizer of one score network, as the JAX package chains it.

Port of ccsd_tpu/training/optim.py:16-40 (optax ``clip_by_global_norm`` ->
``add_decayed_weights`` -> ``scale_by_adam`` -> ``scale_by_learning_rate``),
per step and per network:

1. clip to the global norm with optax's rule: ``g / ||g|| * max_norm``
   where ``||g|| >= max_norm`` (not ``clip_grad_norm_``, which divides by
   ``||g|| + 1e-6``);
2. L2 weight decay added to the gradient (not AdamW's decoupled decay);
3. Adam with bias correction, eps added outside the square root;
4. the learning rate ``lr * lr_decay ** (step // steps_per_epoch)``.

``torch.optim.Adam`` with ``weight_decay`` computes steps 2 and 3 (the decay
is added to the gradient before the moments); the clip runs on the
gradients before it and the rate is set before each step.  A parameter
that took no part in the loss (the last AttentionLayer's node head) steps
on a zero gradient, as under ``jax.grad``: its decay and moments still
move it.  No host sync: the clip's scale stays on the device.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


class Optimizer:
    """Adam with L2 weight decay, global-norm clipping and a per-epoch
    exponential rate decay, over ``params`` (ccsd_tpu/training/optim.py:16)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 0.0, grad_norm: Optional[float] = 1.0,
                 lr_schedule: bool = False, lr_decay: float = 0.999,
                 steps_per_epoch: int = 1, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.lr_schedule, self.lr_decay = lr, lr_schedule, lr_decay
        self.grad_norm, self.steps_per_epoch = grad_norm, max(1, steps_per_epoch)
        self.count = 0  # steps taken, optax's ``count``
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(beta1, beta2), eps=eps,
                                     weight_decay=weight_decay)

    def rate(self, step: int) -> float:
        if not self.lr_schedule:
            return self.lr
        return self.lr * self.lr_decay ** (step // self.steps_per_epoch)

    def clip(self) -> None:
        """Scale the gradients in place to a global norm of at most
        ``grad_norm``."""
        grads = [p.grad for p in self.params]
        if self.grad_norm is None:
            return
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_norm, torch.ones_like(norm),
                            self.grad_norm / norm)
        torch._foreach_mul_(grads, scale)

    def step(self) -> None:
        """One update from the gradients in ``p.grad`` (zero where None)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.clip()
        for group in self.adam.param_groups:
            group["lr"] = self.rate(self.count)
        self.adam.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=False)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])

