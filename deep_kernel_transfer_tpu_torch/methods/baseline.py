"""Baseline and Baseline++: pretrain a classifier over the base classes,
then finetune a fresh head on each test episode's support features.

Port of deep_kernel_transfer_tpu/methods/baseline.py:28-161 (reference
methods/baselinetrain.py, methods/baselinefinetune.py).

`BaselineTrain`: the trunk (`feature`) and a `classifier` over its flat
features, a Linear with zero bias (softmax) or a DistLinear (dist,
baseline++); Adam at 1e-3; train-mode BatchNorm with the running averages
merged after each step. The trunk runs in f32, as the JAX package's does.

`finetune_scores`: the test-time head of BaselineFinetune (and of every
method under --adaptation), for a whole batch of episodes at once: each
episode's head is a slice of one [E, n_way, D] tensor, trained for 100
epochs of minibatches of 4 support features (the last one of an epoch
wrapped round to the permutation's start, JAX baseline.py:131-137) with
torch's SGD(0.01, momentum 0.9, dampening 0.9, weight decay 1e-3) written
on tensors. The summed loss's gradient in one episode's slice is that
episode's own gradient, so the batch is the per-episode loop. The heads'
init and the permutations draw from a torch.Generator, or are given.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..models.backbones import DistLinear, lecun_normal_
from .base import (apply_trunk, episode_cross_entropy, episode_labels,
                   merge_stats, torch_sgd_step)

FINETUNE_EPOCHS, FINETUNE_BATCH = 100, 4


class BaselineTrain(nn.Module):
    """Stage-1 pretraining (reference methods/baselinetrain.py:10-51)."""

    def __init__(self, backbone: nn.Module, num_class: int,
                 loss_type: str = "softmax", lr: float = 1e-3, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.feature = backbone
        self.num_class = num_class
        self.loss_type = loss_type
        self.lr = lr
        self.classifier = None
        self.optimizer = None

    def init(self, example_x: torch.Tensor, generator=None):
        """Initialise for images shaped like example_x [N, H, W, C]: the
        trunk's init and a head sized for the image (lecun normal, zero
        bias; DistLinear g = 1). Returns self."""
        h, w = example_x.shape[-3], example_x.shape[-2]
        self.feature.reset_parameters(generator)
        d = self.feature.out_dim(h, w)
        if self.loss_type == "dist":
            self.classifier = DistLinear(d, self.num_class)
            self.classifier.reset_parameters(generator)
        else:
            self.classifier = nn.Linear(d, self.num_class)
            lecun_normal_(self.classifier.weight, d, generator)
            nn.init.zeros_(self.classifier.bias)
        self.to(self.device)
        self.optimizer = torch.optim.Adam(self.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        return self

    def loss(self, x: torch.Tensor, y: torch.Tensor, batch_sum=None):
        """(mean cross-entropy over the minibatch, BatchNorm stats);
        `batch_sum`: see base.apply_trunk."""
        z, stats = apply_trunk(self.feature, x.to(self.device), train=True,
                               batch_sum=batch_sum)
        scores = self.classifier(z)
        return F.cross_entropy(scores, y.to(self.device).long()), stats

    def train_step(self, x: torch.Tensor, y: torch.Tensor, average=None,
                   batch_sum=None) -> dict:
        """One Adam step on the minibatch (x, y). For a minibatch split
        over ranks (parallel.make_sharded_train_step): `batch_sum` sums
        the BatchNorm statistics' terms over them, and `average` replaces
        the gradients, the statistics and the loss by their means over
        them before the update, as in base.train_step_body."""
        loss, stats = self.loss(x, y, batch_sum)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if average is not None:
            loss = loss.clone()
            average([p.grad for p in self.parameters() if p.grad is not None]
                    + [t for pair in stats.values() for t in pair] + [loss])
        self.optimizer.step()
        merge_stats(stats)
        return {"loss": loss}


def _linear_scores(p: list, z: torch.Tensor) -> torch.Tensor:
    w, b = p
    return z @ w.transpose(-1, -2) + b[..., None, :]


def _dist_scores(p: list, z: torch.Tensor) -> torch.Tensor:
    v, g = p
    z_n = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-5)
    w = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-5) * g
    scale = 2.0 if v.shape[-2] <= 200 else 10.0
    return scale * (z_n @ w.transpose(-1, -2))


def init_heads(e: int, d: int, n_way: int, loss_type: str, generator=None,
               device=None) -> list:
    """E heads as batched tensors: Linear [E, n_way, D] weights (lecun
    normal) and zero biases [E, n_way], or DistLinear v [E, n_way, D] and
    g = 1 [E, n_way, 1]."""
    w = torch.empty(e, n_way, d, device=device)
    lecun_normal_(w, d, generator)
    if loss_type == "dist":
        return [w, torch.ones(e, n_way, 1, device=device)]
    return [w, torch.zeros(e, n_way, device=device)]


def finetune_scores(z: torch.Tensor, n_support: int, loss_type: str,
                    generator=None, heads: list | None = None,
                    perms: torch.Tensor | None = None,
                    epochs: int = FINETUNE_EPOCHS,
                    batch_size: int = FINETUNE_BATCH) -> torch.Tensor:
    """Query scores [E, n_way*Q, n_way] of episodes z [E, n_way, S+Q, D]
    after finetuning a fresh head on each one's support features (JAX
    BaselineFinetune.episode_scores, baseline.py:103-153). `heads` (as
    init_heads gives them) and `perms` [E, epochs, n_way*S] default to
    draws from `generator`."""
    e, n_way, _, d = z.shape
    k = n_way * n_support
    z = z.to(torch.float32)
    z_support = z[:, :, :n_support].reshape(e, k, d)
    z_query = z[:, :, n_support:].reshape(e, -1, d)
    y_support = episode_labels(n_way, n_support, z.device)
    scores_fn = _dist_scores if loss_type == "dist" else _linear_scores
    params = heads if heads is not None else init_heads(
        e, d, n_way, loss_type, generator, z.device)
    if perms is None:
        perms = torch.argsort(torch.rand(e, epochs, k, generator=generator,
                                         device=z.device), dim=-1)
    n_batches = -(-k // batch_size)
    pad = n_batches * batch_size - k
    idx = torch.cat([perms, perms[..., :pad]], dim=-1).reshape(
        e, epochs, n_batches, batch_size)
    rows = torch.arange(e, device=z.device)[:, None]
    bufs = [None] * len(params)
    first = True
    for t in range(epochs):
        for j in range(n_batches):
            ids = idx[:, t, j]
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(True) for p in params]
                loss = episode_cross_entropy(
                    scores_fn(ps, z_support[rows, ids]), y_support[ids]).sum()
                grads = torch.autograd.grad(loss, ps)
            params, bufs = torch_sgd_step([p.detach() for p in params],
                                          list(grads), bufs, first)
            first = False
    return scores_fn(params, z_query)
