"""Tracing and timing helpers.

Port of deep_kernel_transfer_tpu/utils/profiling.py:

  * `annotate(name)`: a named span in torch.profiler traces
    (record_function), and an NVTX range where CUDA is available;
  * `trace(log_dir)`: a torch.profiler trace of a block (CPU, and CUDA
    activity on a CUDA device) written for TensorBoard's profiler plugin;
    `train --profile_dir` traces its first epoch with it;
  * `sync(tree)`: wait for the device work behind the first tensor of a
    tree and read one element of it back;
  * `StepTimer`: wall-clock totals by phase, each phase ending with a
    `sync` of what the phase hands it (PyTorch returns before the card is
    done, so a phase without a sync measures the enqueue).
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any

import torch


@contextlib.contextmanager
def annotate(name: str):
    """A named span: record_function, plus an NVTX range on CUDA."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """A torch.profiler trace of the block into log_dir (TensorBoard's
    trace handler). CUDA activity is traced when `device` is a CUDA device
    (None: when CUDA is available). Yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _leaves(tree):
    if isinstance(tree, dict):  # in key order, as jax.tree.leaves
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sync(tree: Any) -> float:
    """Wait for the device work that produced the first tensor of `tree`
    and read its first element back (0.0 when there is no tensor): one
    scalar crosses to the host, never the whole buffer."""
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return float(x.reshape(-1)[0]) if x.numel() else 0.0
    return 0.0


class StepTimer:
    """Wall-clock totals by phase.

    with timer.phase("data"):            # host work
        batch = next(loader)
    with timer.phase("step") as ph:      # device work: hand the phase the
        m = model.train_step(batch)      # step's OUTPUT to sync on
        ph["sync"] = m
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        holder: dict[str, Any] = {}
        try:
            yield holder
        finally:
            if "sync" in holder:
                sync(holder["sync"])
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {name: {"total_s": self.totals[name],
                       "count": self.counts[name],
                       "mean_ms": self.totals[name]
                       / max(self.counts[name], 1) * 1e3}
                for name in self.totals}

    def report(self) -> str:
        return json.dumps(self.summary(), sort_keys=True)
