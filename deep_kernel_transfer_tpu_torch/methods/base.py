"""Episodic method scaffolding: episode helpers, the trunk's mixed-precision
law, BatchNorm running-average merge and the training-step body.

Port of deep_kernel_transfer_tpu/methods/base.py:27-138, with `ci95`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.backbones import preprocess_input


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
                ep_groups: int = 1):
    """Run a trunk with the reference's BatchNorm semantics and the
    mixed-precision law of the JAX package (methods/base.py:55-96).

    Returns (features float32, stats): in train mode BatchNorm uses batch
    statistics (per episode when ep_groups > 1) and `stats` holds the new
    running averages for merge_stats; in eval mode (train=False) it uses
    the running averages and `stats` is None.

    The law for dtype=bfloat16, written out rather than left to autocast:
      * uint8 images are normalised to float32 before the cast;
      * the input goes to bf16, and every layer casts its float32 master
        weights to bf16 (BatchNorm's scale and bias included);
      * BatchNorm statistics are float32;
      * the features come back as float32.
    """
    stats = {} if train else None
    if dtype is not None and dtype != torch.float32:
        x = preprocess_input(x).to(dtype)
    out = module(x, train, ep_groups, stats)
    return out.to(torch.float32), stats


@torch.no_grad()
def merge_stats(stats: dict | None) -> None:
    """Write the running averages recorded by a train-mode forward
    (stats[bn] = (mean, var), already averaged over episodes) into the
    BatchNorm buffers."""
    for bn, (mean, var) in (stats or {}).items():
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def train_step_body(method, xb: torch.Tensor) -> dict:
    """One training step: loss and gradients over the episode batch, the
    optimizer update, then the BatchNorm running-average merge (JAX
    methods/base.py:119-138)."""
    loss, stats = method.batch_loss_train(xb)
    method.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    method.optimizer.step()
    merge_stats(stats)
    return {"loss": loss.detach()}
