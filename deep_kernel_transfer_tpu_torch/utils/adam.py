"""Adam as optax.adam(lr) computes it, on a list of tensors.

The port's test-time loops (GP adaptation, temperature scaling) take their
steps with this instead of torch.optim.Adam, so that every step follows
optax's order of operations (optax/_src/transform.py scale_by_adam):
b1 0.9, b2 0.999, eps 1e-8 outside the square root, eps_root 0, both
moments bias-corrected, the update scaled by -lr.
"""
from __future__ import annotations

import torch


class Adam:
    """Adam over `params` (tensors updated in place, under no_grad)."""

    def __init__(self, params: list, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            p.add_((mu / c1) / (torch.sqrt(nu / c2) + self.eps) * -self.lr)
