"""Sine/cosine task distribution (reference sines/train_DKT.py:18-111).

Copy of deep_kernel_transfer_tpu/data/sines.py: numpy draws on the host,
so that both packages train and test on the same tasks under the same
RandomState.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SineTask(NamedTuple):
    amplitude: float
    phase: float
    xmin: float
    xmax: float
    family: str = "sine"  # "sine" | "cosine"

    def true_function(self, x):
        fn = np.sin if self.family == "sine" else np.cos
        return self.amplitude * fn(self.phase + x)

    def sample_data(self, rng: np.random.RandomState, size=1, noise=0.0, sort=False):
        """Returns x [size, 1] float32, y [size] float32
        (reference sines/train_DKT.py:34-46)."""
        x = rng.uniform(self.xmin, self.xmax, size)
        if sort:
            x = np.sort(x)
        y = self.true_function(x)
        if noise > 0:
            y = y + rng.normal(0.0, noise, y.shape)
        return x.astype(np.float32).reshape(-1, 1), y.astype(np.float32)


class TaskDistribution(NamedTuple):
    """reference sines/train_DKT.py:84-111."""

    amplitude_min: float = 0.1
    amplitude_max: float = 5.0
    phase_min: float = 0.0
    phase_max: float = float(np.pi)
    x_min: float = -5.0
    x_max: float = 5.0
    family: str = "sine"

    def sample_task(self, rng: np.random.RandomState) -> SineTask:
        amplitude = rng.uniform(self.amplitude_min, self.amplitude_max)
        phase = rng.uniform(self.phase_min, self.phase_max)
        return SineTask(amplitude, phase, self.x_min, self.x_max, self.family)

    def sample_batch(
        self,
        rng: np.random.RandomState,
        batch_size: int,
        samples_per_task: int,
        noise: float = 0.1,
    ):
        """[B, N, 1] inputs + [B, N] targets: a batch of task draws for the
        batched train step (the reference draws one task per iteration,
        sines/train_DKT.py:176-180)."""
        xs, ys = [], []
        for _ in range(batch_size):
            t = self.sample_task(rng)
            x, y = t.sample_data(rng, samples_per_task, noise=noise)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)
