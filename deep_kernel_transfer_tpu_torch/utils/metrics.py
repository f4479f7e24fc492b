"""Metrics: one-hot, Davies-Bouldin index, sparsity (reference utils.py:4-31)
and calibration, the 15-bin ECE and temperature scaling (reference
test_uncertainty.py:39-94).

Port of deep_kernel_transfer_tpu/utils/metrics.py. The first four are numpy
and copied as they are; calibrate_temperature takes its Adam steps with the
port's own optax-ordered Adam (utils/adam.py) on torch tensors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .adam import Adam


def one_hot(y, num_class: int) -> np.ndarray:
    """reference utils.py:4-5."""
    y = np.asarray(y)
    out = np.zeros((len(y), num_class), np.float32)
    out[np.arange(len(y)), y] = 1.0
    return out


def DBindex(cl_data_file: dict) -> float:
    """Davies-Bouldin cluster-separation index (reference utils.py:7-24)."""
    class_list = list(cl_data_file.keys())
    cl_means, stds = [], []
    for cl in class_list:
        arr = np.asarray(cl_data_file[cl])
        cl_means.append(np.mean(arr, axis=0))
        stds.append(np.sqrt(np.mean(np.sum(np.square(arr - cl_means[-1]),
                                           axis=1))))
    mu = np.asarray(cl_means)
    mdists = np.sqrt(np.sum(np.square(mu[None] - mu[:, None]), axis=2))
    dbs = [max((stds[i] + stds[j]) / mdists[i, j]
               for j in range(len(class_list)) if j != i)
           for i in range(len(class_list))]
    return float(np.mean(dbs))


def sparsity(cl_data_file: dict) -> float:
    """Mean number of nonzero feature entries (reference utils.py:26-31)."""
    cl_sparsity = [np.mean([np.sum(x != 0) for x in cl_data_file[cl]])
                   for cl in cl_data_file]
    return float(np.mean(cl_sparsity))


def ece(logits, labels, temperature: float = 1.0, n_bins: int = 15,
        one_vs_rest: bool = False) -> float:
    """15-bin expected calibration error, in float64 (reference
    test_uncertainty.py:76-94). one_vs_rest: sigmoid-normalised
    probabilities for DKT's one-vs-rest logits (:78-81); softmax
    otherwise."""
    logits = np.asarray(logits, np.float64) / temperature
    labels = np.asarray(labels)
    if one_vs_rest:
        s = 1.0 / (1.0 + np.exp(-logits))
        probs = s / s.sum(axis=1, keepdims=True)
    else:
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs = e / e.sum(axis=1, keepdims=True)
    conf = probs.max(axis=1)
    pred = probs.argmax(axis=1)
    acc = (pred == labels).astype(np.float64)
    bins = np.linspace(0, 1, n_bins + 1)
    total = 0.0
    for lo, hi in zip(bins[:-1], bins[1:]):
        in_bin = (conf > lo) & (conf <= hi)
        prop = in_bin.mean()
        if prop > 0:
            total += abs(conf[in_bin].mean() - acc[in_bin].mean()) * prop
    return float(total)


def calibrate_temperature(logits, labels, iterations: int = 200,
                          lr: float = 0.1) -> float:
    """A scalar temperature fitted by minimising the softmax NLL of
    logits / T: `iterations` Adam steps at `lr` on log T from T = 1, in
    float32 on the CPU (the JAX package's protocol, metrics.py:81-107; the
    reference uses LBFGS to the same optimum)."""
    logits_t = torch.as_tensor(np.asarray(logits), dtype=torch.float32)
    labels_t = torch.as_tensor(np.asarray(labels), dtype=torch.long)
    log_t = torch.zeros((), requires_grad=True)
    opt = Adam([log_t], lr)
    for _ in range(iterations):
        nll = F.cross_entropy(logits_t / torch.exp(log_t), labels_t)
        opt.step(torch.autograd.grad(nll, [log_t]))
    return float(torch.exp(log_t.detach()))
