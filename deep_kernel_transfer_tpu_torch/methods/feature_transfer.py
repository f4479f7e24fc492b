"""FeatureTransfer regression baseline: trunk features + Linear(D, 1).

Port of deep_kernel_transfer_tpu/methods/feature_transfer.py (reference
methods/feature_transfer_regression.py, sines/train_FT.py): meta-train the
regressor with plain MSE over tasks; at test take one Adam step on the
support points of a task and predict all its points, or (sines) finetune a
copy for 100 steps of a fresh Adam(1e-2).

Modules carry the reference's names: `feature_extractor` (the trunk) and
`model.layer4` (the Regressor's Linear(2916, 1)).
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.func import functional_call

from .._device import resolve_device
from ..models.backbones import lecun_normal_, trunk_features
from ..utils.adam import Adam


class FeatureTransfer(nn.Module):
    """Build, then `init(example_x)` before training; `step` counts
    optimizer updates."""

    def __init__(self, backbone: nn.Module, lr: float = 1e-3, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.lr = lr
        self.feature_extractor = backbone
        self.model = nn.Module()
        self.model.layer4 = None
        self.optimizer = None
        self.step = 0

    def init(self, example_x: torch.Tensor,
             generator=None) -> "FeatureTransfer":
        """Initialise the trunk from `generator` and a Linear(D, 1) head
        (lecun_normal weights, zero bias, as flax's Dense) for the feature
        width D of one task example_x [N, ...]; a fresh optimizer. Returns
        self."""
        self.feature_extractor.reset_parameters(generator)
        with torch.no_grad():
            d = self.feature_extractor(example_x[:1].to(
                next(self.feature_extractor.parameters()).device)).shape[-1]
        self.model.layer4 = nn.Linear(d, 1)
        lecun_normal_(self.model.layer4.weight, d, generator)
        nn.init.zeros_(self.model.layer4.bias)
        self.to(self.device)
        self.reset_optimizer()
        self.step = 0
        return self

    def reset_optimizer(self) -> None:
        """A fresh Adam at lr over every parameter."""
        self.optimizer = torch.optim.Adam(self.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Predictions [...] of inputs [..., ...input shape], true f32."""
        z = trunk_features(self.feature_extractor, x.to(self.device))
        return self.model.layer4(z)[..., 0]

    def task_loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean((self(x) - y.to(self.device)) ** 2)

    def batch_loss(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """Mean over the tasks of each task's MSE, xb [B, N, ...]."""
        return torch.mean(torch.mean((self(xb) - yb.to(self.device)) ** 2,
                                     dim=-1))

    def train_step(self, xb: torch.Tensor, yb: torch.Tensor) -> dict:
        loss = self.batch_loss(xb, yb)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach()}

    def _params(self) -> dict:
        return {k: v.detach() for k, v in self.named_parameters()}

    def _support_grads(self, params: dict, x: torch.Tensor,
                       y: torch.Tensor) -> dict:
        """Gradients of the support MSE at `params` (a name -> tensor dict)."""
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            pred = functional_call(self, leaves, (x,))
            loss = torch.mean((pred - y.to(self.device)) ** 2)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads))

    @torch.no_grad()
    def adapt_and_predict(self, x_support: torch.Tensor,
                          y_support: torch.Tensor,
                          x_all: torch.Tensor) -> torch.Tensor:
        """One Adam step on the support MSE from the model's weights and
        its optimizer's state, then predictions at x_all (reference
        feature_transfer_regression.py:52-80; JAX feature_transfer.py
        :55-67). The model itself is left untouched; a freshly built or
        loaded model has a fresh optimizer state, as the JAX CLI's."""
        params = self._params()
        grads = self._support_grads(params, x_support, y_support)
        new = {k: v.clone() for k, v in params.items()}
        opt = Adam(list(new.values()), self.lr)
        state = self.optimizer.state
        for i, p in enumerate(self.parameters()):
            if p in state and "step" in state[p]:
                opt.mu[i].copy_(state[p]["exp_avg"])
                opt.nu[i].copy_(state[p]["exp_avg_sq"])
                opt.count = int(state[p]["step"])
        opt.step([grads[k] for k in new])
        return functional_call(self, new, (x_all,))

    def test_mse(self, x_support, y_support, x_all, y_all) -> float:
        pred = self.adapt_and_predict(x_support, y_support, x_all)
        return float(torch.mean((pred - y_all.to(self.device)) ** 2))

    @torch.no_grad()
    def finetune_and_predict(self, support, x_all: torch.Tensor,
                             steps: int = 100,
                             lr: float = 1e-2) -> torch.Tensor:
        """Finetune a copy on the support for `steps` steps of a fresh
        Adam(lr), then predict x_all (reference sines/train_FT.py:189-216;
        JAX feature_transfer.py:73-89)."""
        x_support, y_support = support
        new = {k: v.clone() for k, v in self._params().items()}
        opt = Adam(list(new.values()), lr)
        for _ in range(steps):
            grads = self._support_grads(new, x_support, y_support)
            opt.step([grads[k] for k in new])
        return functional_call(self, new, (x_all,))
