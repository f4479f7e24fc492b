"""Tracing helpers.

Port of deep_kernel_transfer_tpu/utils/profiling.py:

  * `annotate(name)`: the span `dkt.<name>` in torch.profiler traces
    (record_function), opened only while a profiler runs;
  * `trace(log_dir)`: a torch.profiler trace of a block (CPU, and CUDA
    activity on a CUDA device) written for TensorBoard's profiler plugin;
    `train --profile_dir` traces its first epoch with it.

The port's spans sit at its layer boundaries, nested as listed:

    dkt.step       methods/base.py::train_step_body, the whole step
      dkt.forward    the loss's forward (method.batch_loss_train)
        dkt.trunk      methods/base.py::apply_trunk (train and eval mode)
          dkt.block      models/backbones.py::SimpleBlock.forward and
                         BottleneckBlock.forward, once a residual block;
                         SwinBlock.forward, once a Swin block
            dkt.residual   the block's shortcut branch, the add and the ReLU
            dkt.attention  a Swin block's LayerNorm1, qkv product, window
                           attention (ops/window_attention.py) and output
                           projection
          dkt.merge      models/backbones.py::PatchMerging.forward
          dkt.batchnorm  models/backbones.py::EpisodicBatchNorm.forward
                         (inside dkt.block and dkt.residual where a block
                         holds it)
        dkt.gp         methods/dkt.py::DKT._mll (fused MLL or ExactGP)
      dkt.backward   zero_grad and loss.backward()
      dkt.average    the episode-parallel all-reduce, where given
      dkt.update     optimizer.step() and the BatchNorm merge
    dkt.posterior  methods/dkt.py::DKT._logits_from_features (eval head)
    dkt.draw       data/device_dataset.py::_draw (sampling and gather)
      dkt.augment    the on-card crop-resize, jitter and flip

A backward kernel is launched under `dkt.backward` by an autograd op that
carries the `sequence_nr` of the forward op that made it, so a trace
reader can charge it to that forward op's spans too.
"""
from __future__ import annotations

import contextlib

import torch

SPAN_PREFIX = "dkt."


def annotate(name: str):
    """The span `dkt.<name>` around a block while a profiler runs; a no-op
    context otherwise (record_function costs several microseconds a call
    even with no profiler running)."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


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
