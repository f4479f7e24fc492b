"""MAML and its first-order approximation.

Port of deep_kernel_transfer_tpu/methods/maml.py:35-136 (reference
methods/maml.py). The network is the trunk (`feature`) and a Linear
`classifier` over its flat features, zero bias. Per episode the inner
loop takes `task_update_num` SGD steps at `train_lr` on the support
cross-entropy from the shared weights ("fast weights" through
torch.func.functional_call); the query scores come from the adapted
weights. The second-order gradient flows through torch.autograd.grad with
create_graph=True; maml_approx (approx=True) takes the inner gradients
as constants. BatchNorm uses batch statistics at train AND test time and
its running averages are never updated (the reference's always-training
BatchNorm2d_fw, backbone.py:94-102). The outer loss is the SUM of the
episode losses (reference maml.py:89-92). The trunk runs in f32, as the
JAX package's MAML does. The episodes of a batch adapt one after another.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..models.backbones import lecun_normal_
from .base import EpisodicMethod, episode_labels, query_accuracy


class MAML(EpisodicMethod):
    loss_reduction = "sum"  # the episodes' losses (parallel.mesh)

    def __init__(self, backbone: nn.Module, n_way: int, n_support: int,
                 approx: bool = False, n_task: int = 4,
                 task_update_num: int = 5, train_lr: float = 0.01,
                 lr: float = 1e-3, device=None):
        super().__init__(n_way, n_support, lr, "float32", device)
        self.feature = backbone
        self.classifier = None
        self.approx = approx
        self.n_task = n_task
        self.task_update_num = task_update_num
        self.train_lr = train_lr

    def reset_parameters(self, example_episode, generator=None) -> None:
        """The trunk's init; a Linear head sized for the image, lecun
        normal, zero bias (JAX maml.py:39-48)."""
        h, w = example_episode.shape[-3], example_episode.shape[-2]
        self.feature.reset_parameters(generator)
        d = self.feature.out_dim(h, w)
        self.classifier = nn.Linear(d, self.n_way)
        lecun_normal_(self.classifier.weight, d, generator)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Scores of images x [N, H, W, C], BatchNorm on x's statistics."""
        return self.classifier(self.feature(x, True, 1, None))

    def _scores(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return functional_call(self, params, (x,))

    def adapted_scores(self, x: torch.Tensor,
                       create_graph: bool) -> torch.Tensor:
        """Query scores [n_way*Q, n_way] of one episode [n_way, S+Q, H, W,
        C] after the inner loop (reference maml.py:40-58). create_graph
        keeps the graph of the inner steps for the outer gradient
        (second order); without it, or with `approx`, the inner gradients
        are constants."""
        x = x.to(self.device)
        n_way, s = x.shape[0], self.n_support
        img = tuple(x.shape[2:])
        x_s = x[:, :s].reshape((-1,) + img)
        x_q = x[:, s:].reshape((-1,) + img)
        y_s = episode_labels(n_way, s, self.device)
        fast = dict(self.named_parameters())
        second = create_graph and not self.approx
        for _ in range(self.task_update_num):
            loss = F.cross_entropy(self._scores(fast, x_s), y_s)
            grads = torch.autograd.grad(loss, list(fast.values()),
                                        create_graph=second)
            fast = {k: p - self.train_lr * g
                    for (k, p), g in zip(fast.items(), grads)}
        return self._scores(fast, x_q)

    def batch_losses_train(self, xb: torch.Tensor):
        """(per-episode query cross-entropies [B], no stats)."""
        y = self.query_labels(xb.shape[1], xb.shape[2] - self.n_support)
        losses = torch.stack([F.cross_entropy(
            self.adapted_scores(x, create_graph=True), y) for x in xb])
        return losses, None

    def batch_loss_train(self, xb: torch.Tensor):
        """(SUM of the episode losses, no stats) (JAX maml.py:124-136)."""
        losses, _ = self.batch_losses_train(xb)
        return losses.sum(), None

    def batch_scores(self, xb: torch.Tensor) -> torch.Tensor:
        """[B, n_way*Q, n_way] adapted query scores; the inner loop needs
        gradients even under torch.no_grad."""
        with torch.enable_grad():
            out = [self.adapted_scores(x, create_graph=False).detach()
                   for x in xb]
        return torch.stack(out)

    def batch_correct(self, xb: torch.Tensor) -> torch.Tensor:
        return query_accuracy(torch.argmax(self.batch_scores(xb), dim=-1),
                              xb.shape[1])
