"""Episodic method scaffolding: episode helpers, the trunk's mixed-precision
law, BatchNorm running-average merge, the training-step body and the
generic episodic contract of the comparison methods.

Port of deep_kernel_transfer_tpu/methods/base.py:27-219, with `ci95`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import resolve_device
from ..models.backbones import BatchStats, preprocess_input
from ..utils.profiling import annotate


def flatten_episode(x: torch.Tensor) -> torch.Tensor:
    """[n_way, K, ...] -> [n_way*K, ...]."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def episode_labels(n_way: int, k: int, device=None) -> torch.Tensor:
    """np.repeat(range(n_way), k) (reference meta_template.py:47)."""
    return torch.arange(n_way, device=device).repeat_interleave(k)


def one_vs_rest_targets(n_way: int, k: int, device=None) -> torch.Tensor:
    """[n_way, n_way*k] float32 +-1 targets: row w is +1 on the block
    [w*k, (w+1)*k) and -1 elsewhere (reference methods/DKT.py:129-136)."""
    labels = episode_labels(n_way, k, device)
    onehot = (labels[None, :] == torch.arange(n_way, device=device)[:, None])
    return 2.0 * onehot.to(torch.float32) - 1.0


def ci95(acc_per_episode) -> float:
    """Half-width 1.96 std / sqrt(n) of the accuracy's 95% interval
    (reference test.py:174; JAX methods/base.py:47-52)."""
    a = np.asarray(acc_per_episode)
    return float(1.96 * a.std() / np.sqrt(len(a)))


def apply_trunk(module, x: torch.Tensor, train: bool, dtype=None,
                ep_groups: int = 1, batch_sum=None):
    """Run a trunk with the reference's BatchNorm semantics and the
    mixed-precision law of the JAX package (methods/base.py:55-96).

    Returns (features float32, or float64 for a float64 trunk, stats): in
    train mode BatchNorm uses batch statistics (per episode when
    ep_groups > 1) and `stats` holds the new running averages for
    merge_stats; in eval mode (train=False) it uses the running averages
    and `stats` is None.

    The law for dtype=bfloat16, written out rather than left to autocast:
      * uint8 images are normalised to float32 before the cast;
      * the input goes to bf16, and every layer casts its float32 master
        weights to bf16 (BatchNorm's scale and bias included);
      * BatchNorm statistics are float32;
      * the features come back as float32.

    `batch_sum` (train mode): where the ranks split the batch between
    them, a sum over the ranks with gradients (parallel.mesh.dp_sum); the
    BatchNorm statistics are then the whole batch's (BatchStats).
    """
    with annotate("trunk"):
        stats = BatchStats(batch_sum) if train else None
        if dtype is not None and dtype != torch.float32:
            x = preprocess_input(x).to(dtype)
        out = module(x, train, ep_groups, stats)
        return out.to(torch.promote_types(out.dtype, torch.float32)), stats


@torch.no_grad()
def merge_stats(stats: dict | None) -> None:
    """Write the running averages recorded by a train-mode forward
    (stats[bn] = (mean, var), already averaged over episodes) into the
    BatchNorm buffers."""
    for bn, (mean, var) in (stats or {}).items():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def train_step_body(method, xb: torch.Tensor, average=None) -> dict:
    """One training step: loss and gradients over the episode batch, the
    optimizer update, then the BatchNorm running-average merge (JAX
    methods/base.py:119-138). `average`, where given, replaces a list of
    tensors in place by their means over the episode-parallel ranks (their
    sums for a loss that sums its episodes, MAML's;
    parallel/mesh.py::make_sharded_train_step): the gradients, the
    BatchNorm statistics and the loss go through it between the backward
    and the update, which is what the JAX psum computes."""
    with annotate("step"):
        with annotate("forward"):
            loss, stats = method.batch_loss_train(xb)
        with annotate("backward"):
            method.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        if average is not None:
            loss = loss.clone()
            with annotate("average"):
                average([p.grad for group in method.optimizer.param_groups
                         for p in group["params"] if p.grad is not None]
                        + [t for pair in (stats or {}).values() for t in pair]
                        + [loss])
        with annotate("update"):
            method.optimizer.step()
            merge_stats(stats)
    return {"loss": loss}


class EpisodicMethod(nn.Module):
    """The episodic contract of the comparison methods (JAX
    methods/base.py:141-219; reference meta_template.py:45-100).

    A subclass holds its trunk as `feature` and defines
    `reset_parameters(example_episode, generator)`,
    `scores_from_features(z)` (features [B, n_way, S+Q, ...] -> scores
    [B, n_way*Q, n_way]) and, where its loss is not the cross-entropy of
    those scores, `batch_losses_train`. The trunk runs once over the flat
    episode batch, with per-episode BatchNorm statistics in train mode
    (ep_groups=B), which is what the JAX package's vmap over episodes
    computes. One Adam at `lr` over every parameter (reference
    train.py:40)."""

    def __init__(self, n_way: int, n_support: int, lr: float = 1e-3,
                 feature_dtype: str = "bfloat16", device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.n_way = n_way
        self.n_support = n_support
        self.lr = lr
        self.feature_dtype = getattr(torch, feature_dtype)
        self.optimizer = None

    def init(self, example_episode: torch.Tensor, generator=None):
        """Initialise every parameter for episodes shaped like
        example_episode [n_way, S+Q, H, W, C] (content ignored), from
        `generator`, and a fresh optimizer. Returns self."""
        self.reset_parameters(example_episode, generator)
        self.to(self.device)
        self.optimizer = torch.optim.Adam(self.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        return self

    def batch_features(self, xb: torch.Tensor, train: bool = False):
        """(features [B, n_way, S+Q, ...], stats) of episodes xb [B, n_way,
        S+Q, H, W, C]: one trunk forward over the flat batch."""
        xb = xb.to(self.device)
        lead = xb.shape[:3]
        z, stats = apply_trunk(self.feature,
                               xb.reshape((-1,) + tuple(xb.shape[3:])),
                               train, dtype=self.feature_dtype,
                               ep_groups=lead[0] if train else 1)
        return z.reshape(lead + tuple(z.shape[1:])), stats

    def query_labels(self, n_way: int, n_query: int) -> torch.Tensor:
        return episode_labels(n_way, n_query, self.device)

    def batch_losses_train(self, xb: torch.Tensor):
        """(per-episode losses [B], stats): the cross-entropy of the query
        scores in train mode."""
        z, stats = self.batch_features(xb, train=True)
        scores = self.scores_from_features(z)
        y = self.query_labels(xb.shape[1], xb.shape[2] - self.n_support)
        return episode_cross_entropy(scores, y), stats

    def batch_loss_train(self, xb: torch.Tensor):
        """(mean over episodes of the loss, BatchNorm stats)."""
        losses, stats = self.batch_losses_train(xb)
        return losses.mean(), stats

    def batch_loss(self, xb: torch.Tensor) -> torch.Tensor:
        return self.batch_loss_train(xb)[0]

    def episode_loss(self, x: torch.Tensor) -> torch.Tensor:
        return self.batch_loss(x[None])

    def train_step(self, xb: torch.Tensor, average=None) -> dict:
        return train_step_body(self, xb.to(self.device), average)

    @torch.no_grad()
    def batch_scores(self, xb: torch.Tensor) -> torch.Tensor:
        """[B, n_way*Q, n_way] scores, eval-mode BatchNorm."""
        return self.scores_from_features(self.batch_features(xb)[0])

    def correct(self, x: torch.Tensor) -> tuple[float, int]:
        """(top-1 correct, count) on one episode [n_way, S+Q, ...]."""
        n_way, n_query = x.shape[0], x.shape[1] - self.n_support
        pred = torch.argmax(self.batch_scores(x[None])[0], dim=-1)
        y = self.query_labels(n_way, n_query)
        return float((pred == y).sum()), n_way * n_query

    def batch_correct(self, xb: torch.Tensor) -> torch.Tensor:
        """Per-episode query accuracy in percent, [B]."""
        return query_accuracy(torch.argmax(self.batch_scores(xb), dim=-1),
                              xb.shape[1])


def episode_nll(logp: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-episode mean negative log-likelihood [B] of log-probabilities
    logp [B, M, W] of labels y [M] (or [B, M])."""
    return -logp.gather(-1, y.expand(logp.shape[:-1])[..., None])[
        ..., 0].mean(-1)


def episode_cross_entropy(scores: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Per-episode mean softmax cross-entropy [B] of scores [B, M, W]
    against labels y [M] (or [B, M])."""
    return episode_nll(F.log_softmax(scores, dim=-1), y)


def query_accuracy(pred: torch.Tensor, n_way: int) -> torch.Tensor:
    """Per-episode accuracy in percent [B] of the class ids pred
    [B, n_way*Q]."""
    y = episode_labels(n_way, pred.shape[-1] // n_way, pred.device)
    return torch.mean((pred == y).to(torch.float32), dim=-1) * 100.0


def torch_sgd_step(params: list, grads: list, bufs: list, first: bool,
                   lr: float = 0.01, momentum: float = 0.9,
                   dampening: float = 0.9,
                   weight_decay: float = 1e-3) -> tuple[list, list]:
    """One step of torch.optim.SGD(lr, momentum, dampening, weight_decay)
    written on tensors, the finetuning optimizer of the reference
    (baselinefinetune.py:37, relationnet.py:52): g += wd·p; buf = g on the
    first step, else momentum·buf + (1 - dampening)·g; p -= lr·buf.
    Returns (new params, new bufs)."""
    new_p, new_b = [], []
    for p, g, b in zip(params, grads, bufs):
        g = g + weight_decay * p
        b = g if first else momentum * b + (1.0 - dampening) * g
        new_p.append(p - lr * b)
        new_b.append(b)
    return new_p, new_b
