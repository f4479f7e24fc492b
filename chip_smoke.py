"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit) and the torch/CUDA versions.
2. Builds every CUDA kernel of the port from `csrc/` with nvcc and prints
   each kernel's registers, shared memory and spills (`-Xptxas -v`).
3. Profiles with torch.profiler one forward and one backward of the fused
   MLL at the main path's shape (and checks that the backward runs no
   triangular solve), and one call of each large-support-set Cholesky
   kernel at its timed shape: device ms and launches by kernel, and the
   idle gaps between launches.
4. Holds each kernel against its plain torch version on the card at the
   main paths' shapes, and times kernel, plain version and the stock
   library call with CUDA events, in turns: the fused MLL (with shared
   and with per-episode GP parameters, the latter at the digits
   adaptation shape and the main one), the three large-support-set
   Cholesky kernels (blocked, left-looking, fused Gram with its tiled
   form), and the episodic BatchNorm(+ReLU) kernels at every trunk
   BatchNorm shape of the three train cells (forward, statistics and
   gradients against the plain version, two calls bit-equal; forward+
   backward timed beside the plain version, the module's torch route and
   the 10-bytes-an-element bound), and the eval-mode BatchNorm(+ReLU)
   kernel at Conv4's eval batch and two ResNet50 shapes (against the
   module's eval torch route within a bf16 ulp, two calls bit-equal, its
   launches counted; timed beside the torch route and the 4-bytes-an-
   element bound), and the shifted-window attention kernels at one
   stage-1 Swin-T block of 840 images (o, dqkv and the bias table's
   gradient against the torch chain, o bit-equal over two calls, one
   launch each way; forward+backward timed beside the chain and the
   22-bytes-an-element bound).
5. Drives the main paths, each with the launch counts set to 0 just before
   and read just after:
   - DKT meta-training (Conv4, bncossim, 5-way 5-shot 15-query, 84x84x3
     uint8 episodes, 32 episodes a step, bf16 trunk) for a few steps
     through the fused-MLL kernel; checks the losses, the kernel's launch
     count, that every 4-D BatchNorm took the episodic BatchNorm kernels
     once each way with no layout copy, and the fused route against the
     plain route, runs the eval
     head on one batch (its 4 BatchNorms on the eval kernel, none left to
     torch, no layout copy), times a train step on both GP routes in turns and prints a
     torch.profiler table of the step's device time by kernel;
   - the GP engine's memory regime: Cholesky logdets and their gradients
     at the JAX benchmark's shapes and the memory demo's fused arm at
     N = 32768;
   - the CLIs at full width, in a temporary working directory: a
     miniImagenet-layout dataset (64/16/20 classes x 600 images, 96x96
     PNGs written by a stdlib writer, each class with a visible signature)
     with its stage caches written beforehand (no image decoder needed);
     first the native decoder's check: whether g++, jpeglib.h and png.h
     are there and the library built, then the val split staged cold
     (eval and canvas) by the decoder the CLIs take there (native where
     it built, else PIL), images a second, its pixels against the
     written ones (exact: the resampling is the identity at 96 px) and,
     where both decoders run, PIL's on a sample;
     then `train.main` (Conv4, DKT, --train_aug, 32 episodes a batch, 2
     epochs of 10 batches) and the 600-episode `test.main`; checks the
     caches, the kernel's 20 launches, the losses, the telemetry, the
     checkpoints and the accuracy, and times staging, sample+augment, the
     CLI's train batch, the epochs and the eval;
   - DKT's test-time heads on the committed digits (28-px JPEGs written
     in a temporary directory): 2 epochs of `train.main`, then
     `test.main` plain, --laplace and --adaptation (600 episodes each)
     and `test_uncertainty.main`; checks the adaptation's 100 fused-MLL
     launches for each episode batch, the accuracies and the ECEs, and
     prints each head's wall time;
   - DKT on ResNet10 at 224 px (5-way 5-shot 16-query, N = 105, D = 512,
     8 episodes a step, bf16 trunk): the fused MLL at that shape against
     its plain version and timed with its library call; 5 train steps
     with the kernels' launches counted (the BatchNorm's as on the main
     path), the fused route against the
     plain one, the step's ms, episodes/s, peak memory and profile; then
     `train` and `test` through the CLI on a generated 224-px set;
   - DKT on ResNet50 at 224 px (the benchmark cell resnet50_cub_train_b8's
     shapes: N = 105, D = 2048, 8 episodes a step, bf16 trunk): the fused
     MLL at that shape against its plain version and timed; 3 train steps
     with the launches counted (all 49 BatchNorms on the kernels), the
     fused route against the plain one, the step's ms and peak;
   - DKT on Swin-T at 224 px (the benchmark cell swint_cub_train_b8's
     shapes: N = 105, D = 768, 8 episodes a step, bf16 trunk): the fused
     MLL at that shape against its plain version and timed; 3 train steps
     with the launches counted (every block's attention on the kernels,
     one launch each way a block a step), the fused route against the
     plain one, and one step's peak on the kernels against the torch
     chain;
   - episode parallelism at the main path's width (drive_parallel_path):
     (a) 5 steps of the sharded step on an NCCL group of one rank against
     5 plain train_steps, launches counted, both timed in turns; (b) two
     processes on the one card over gloo, 16 episodes each, against the
     one-process step on the 32 (loss, averaged gradients, weights, and
     the weights equal on both ranks); (c) `train.main --n_devices=1`,
     and --n_devices=2 refused on one card; (d) four gloo ranks on the
     card, dp=2 x tp=2, the conv weights and their Adam moments stored as
     tp chunks (tensor_sharding_rules, min_size 1 << 10), one step on
     16 episodes (cut from 32: four ranks of 16 do not fit the card)
     against the one-process step on them (the same checks, the
     gathered weights equal on all four, a rank's bytes half the
     replicated ones, one launch a rank, ms a step beside the
     one-process step's); (e) protonet, matchingnet, relationnet, maml
     and BaselineTrain's batch-sharded step on two gloo ranks (Conv4,
     84 px, 4 episodes or 16 images) against one process (the whole
     batch in one process printed beside it); (f) second-order MAML and
     MatchingNet on four gloo ranks, dp=2 x tp=2, f32, their conv and
     LSTM weights as tp chunks, against one process; then a
     torch.profiler trace (utils/profiling.py) of two train steps, each
     `dkt.` span of the step opened twice;
   the study runners of deep_kernel_transfer_tpu_torch/benchmarks through
   their `main` at full width and cut depth (drive_studies_path): the
   step's segment profile at B = 32, ResNet10's at B = 8 with the knee at
   8 and 16, the jitter-probe A/B, the matmul peak at bf16 N = 4096 and
   8192 and f32 N = 4096, the train CLI's throughput with 2 added epochs,
   and DKT's budget sweep at 1 and 5 shots with the linear kernel, 2
   epochs a run: every segment finite and positive, the peaks under the
   datasheet's rates, the fused MLL's launches counted;
   the Laplace probe (drive_laplace_probe_path) on the checkpoints that
   sweep leaves, 20 novel episodes at 1 and 5 shots: arm (a) the port's
   Laplace head in f32 on the card, arm (b) the port's float64 copy of
   scikit-learn's classifier on the host (scikit-learn not loaded), arm
   (c) the learned GP head, each above 35%, and the support Gram's mean
   off-diagonal; no kernel launched;
   then the exact GP's Woodbury route against its dense route at N=4096,
   D=256: agreement, ms and peak memory of each; the Woodbury CLI
   workload at full width (250 glyph classes, DKT Conv4S bncossim, 20-way
   15-shot, 8 episodes a batch, 28 px) cut to 2 epochs: the step A/B's
   episodes/s on both routes, `train`, `test` on both arms, routes
   N = 620 and 300 checked, no kernel launched, the arms' accuracies
   within 0.2 points and above a floor; and every comparison
   method (protonet, matchingnet, relationnet, relationnet_softmax, maml,
   maml_approx, baseline, baseline++) through `train`, `save_features`
   and `test` (and `test --adaptation` for maml and relationnet) on a
   smaller set of the CLI phase's layout, Conv4 at 84 px: checkpoints,
   caches, finite losses, accuracy above 50%, seconds of each part;
   then the regression track, which launches no kernel of the port (and
   must not): the synthetic QMUL grid (29 people x 13 pitches x 19
   angles of 100-px JPEGs), DKT rbf, DKT spectral and transfer on the CPU
   against the card on one 24-person batch, `train_regression` (Conv3,
   --task_batch=1) for 10 epochs each and `test_regression` on each
   checkpoint, with ms a per-person and a batched step, s an epoch, peak
   GiB and a profile of one epoch; and the sines scripts (train_DKT 500
   iterations with a 250-task eval, train_FT 500 with 50 tasks,
   train_MAML 100 meta-steps with 50 tasks).
6. Prints one JSON line of kernel results, then as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no last
line. It needs a CUDA device and the package beside it; it imports nothing
of the JAX package.
"""
from __future__ import annotations

import collections
import json
import math
import multiprocessing
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM datasheet peaks (dense), used for each kernel's bound. The
# tile-Cholesky kernels form their products in 3xTF32: three TF32 passes
# for each f32 product, so f32 work at a third of the TF32 rate.
PEAK_F32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12

MAIN_B, MAIN_WAY, MAIN_SHOT, MAIN_QUERY, MAIN_PX = 32, 5, 5, 15, 84
MAIN_D = 1600
NOISE = 0.1


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ms_in_turns(fns: dict, rounds: int = 5, iters: int = 20,
                warmup: int = 3) -> dict:
    """name -> (median, min, max) ms per call over `rounds` timings of each
    fn, taken in turns (a, b, c, c, b, a, ...) so that a drift of clocks or
    power between them falls on every fn alike."""
    samples = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            samples[name].append(cuda_ms(fns[name], iters, warmup))
    return {name: (statistics.median(v), min(v), max(v))
            for name, v in samples.items()}


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-8))


def mll_inputs(b: int, n: int, d: int, w: int, device,
               per_episode: bool = False):
    """bncossim-like unit-norm features and one-vs-rest diffs offset by a
    non-zero constant mean; shared scales [W] and diffs [W, N], or with
    per_episode each episode's own, scales [B, W] and diffs [B, W, N], as
    test-time adaptation gives them."""
    rng = np.random.RandomState(n)
    z = rng.randn(b, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    labels = np.arange(n) % w
    diffs = np.where(labels[None, :] == np.arange(w)[:, None], 1.0, -1.0)
    diffs = (diffs - 0.13).astype(np.float32)
    scales = np.linspace(0.4, 1.5, w).astype(np.float32)
    if per_episode:
        scales = (scales * rng.uniform(0.5, 2.0, (b, w))).astype(np.float32)
        diffs = (diffs - rng.uniform(-0.3, 0.3, (b, w, 1))).astype(np.float32)
    return (torch.from_numpy(z).to(device), torch.from_numpy(diffs).to(device),
            torch.from_numpy(scales).to(device))


def library_mll(z, diffs, scales, noise):
    """The same MLL from stock torch calls (cuBLAS matmul, cuSOLVER
    Cholesky, cholesky_solve): the yardstick, never used by the port."""
    n = z.shape[1]
    g = torch.matmul(z, z.transpose(-1, -2))
    k = scales[..., None, None] * g[:, None] + (noise + 1e-6) * torch.eye(
        n, device=z.device)
    chol = torch.linalg.cholesky(k)
    rhs = diffs[..., None].expand(z.shape[0], -1, -1, -1)
    alpha = torch.cholesky_solve(rhs, chol)
    quad = (rhs * alpha).sum((-1, -2))
    logdet = 2 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (quad + logdet + n * math.log(2 * math.pi)) / n


def bound_ms(flops: float, nbytes: float,
             rate: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time on an H100 SXM for f32 work at `rate` FLOP/s: max(
    operations / rate, bytes / memory rate), and which of the two binds."""
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def fused_mll_bound_ms(b: int, n: int, d: int, w: int,
                       per_episode: bool = False) -> tuple[float, str]:
    """The Gram's lower triangle with its diagonal (B·N(N+1)·D; G is
    symmetric and the factor reads no more) + Cholesky and explicit inverse
    (2N³/3) + the two products with the inverse (2N²) per (episode, way) in
    f32; Z, diffs, scales (shared, or each episode's own) read once, mll,
    L⁻¹, alpha and G written once."""
    flops = (1.0 * b * n * (n + 1) * d
             + b * w * (2.0 * n ** 3 / 3.0 + 2.0 * n * n))
    params = (b if per_episode else 1) * (w * n + w)
    nbytes = 4.0 * (b * n * d + params + b * w + b * w * n * n + b * w * n
                    + b * n * n)
    return bound_ms(flops, nbytes)


def cholesky_bound_ms(b: int, n: int,
                      rate: float = TF32X3_FLOPS) -> tuple[float, str]:
    """B·N³/3 f32 operations; K's lower triangle read, dense L written."""
    return bound_ms(b * n ** 3 / 3.0, 4.0 * (b * n * (n + 1) / 2 + b * n * n),
                    rate)


def fused_gram_bound_ms(b: int, n: int, d: int, tiled: bool = False,
                        rate: float = TF32X3_FLOPS) -> tuple[float, str]:
    """The Gram's lower triangle (B·N(N+1)·D) + the factor (B·N³/3); Z
    read, L written: dense, or only the nt(nt+1)/2 lower tiles when
    tiled."""
    nt = n // 128
    out = nt * (nt + 1) / 2 * 128 * 128 if tiled else n * n
    return bound_ms(b * (n * (n + 1) * d + n ** 3 / 3.0),
                    4.0 * (b * n * d + b * out), rate)


def fused_mll_errors(b: int, n: int, d: int, w: int, device,
                     per_episode: bool = False) -> dict:
    """The fused-MLL kernel (one launch) against its plain version on the
    same inputs: mll (absolute), the residuals L⁻¹, alpha and G, and the
    gradients in z, diffs and scales through the shared backward (relative
    to each one's largest entry)."""
    from deep_kernel_transfer_tpu_torch.ops import fused_mll as fm

    z, diffs, scales = mll_inputs(b, n, d, w, device, per_episode)
    got = launched_once(fm.fused_linear_mll, lambda: fm._forward_cuda(
        z, diffs, scales, NOISE, 1e-6))
    want = fm._forward_plain(z, diffs, scales, NOISE, 1e-6)
    errs = {"mll": float((got[0] - want[0]).abs().max())}
    errs.update({k: rel_err(a, c) for k, a, c in
                 zip(("L^-1", "alpha", "G"), got[1:], want[1:])})
    grads = []
    for fn in (fm.fused_linear_mll, fm.fused_linear_mll_plain):
        args = [t.clone().requires_grad_(True) for t in (z, diffs, scales)]
        grads.append(torch.autograd.grad(-fn(*args, n, NOISE).sum(), args))
    errs.update({f"grad {k}": rel_err(a, c) for k, a, c in
                 zip(("z", "diffs", "scales"), *grads)})
    return errs


FUSED_MLL_LIMITS = {"mll": 1e-5, "L^-1": 1e-5, "alpha": 1e-5, "G": 1e-5,
                    "grad z": 2e-2, "grad diffs": 2e-2, "grad scales": 2e-2}


def check_ragged_shape(device) -> None:
    """Shapes off every tile: N = 30, D = 97 (no multiple of the kernel's
    32-deep chunks, nor of 4), W = 3; N = 1; N = 65 (one row into a third
    sub-panel) with D = 33 and W = 11."""
    for b, n, d, w in ((3, 30, 97, 3), (2, 1, 7, 2), (4, 65, 33, 11)):
        check(f"fused_mll B={b} N={n} D={d} W={w}",
              fused_mll_errors(b, n, d, w, device), FUSED_MLL_LIMITS)


def check_fused_mll(device) -> dict:
    """Kernel against plain version at N in {85, 100, 128}; timings at the
    main path's N = 100. Returns the kernel's JSON entry (launches filled
    in by the main path)."""
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import (
        fused_linear_mll, fused_linear_mll_plain)

    n = MAIN_WAY * (MAIN_SHOT + MAIN_QUERY)
    fwd_err = None
    for nn in (85, n, 128):
        errs = fused_mll_errors(MAIN_B, nn, MAIN_D, MAIN_WAY, device)
        check(f"fused_mll B={MAIN_B} N={nn} D={MAIN_D} W={MAIN_WAY}", errs,
              FUSED_MLL_LIMITS)
        if nn == n:
            fwd_err = errs["mll"]
    z, diffs, scales = mll_inputs(MAIN_B, n, MAIN_D, MAIN_WAY, device)
    times = ms_in_turns({
        "kernel": lambda: fused_linear_mll(z, diffs, scales, n, NOISE),
        "plain": lambda: fused_linear_mll_plain(z, diffs, scales, n, NOISE),
        "library": lambda: library_mll(z, diffs, scales, NOISE)})
    return kernel_entry(
        "fused_linear_mll", "fused_mll.cu",
        "deep_kernel_transfer_tpu/ops/pallas/fused_mll.py:165", fwd_err,
        times, fused_mll_bound_ms(MAIN_B, n, MAIN_D, MAIN_WAY),
        f"B={MAIN_B} N={n} D={MAIN_D} W={MAIN_WAY}")


ADAPT_SHAPE = (32, 25, 64, 5)  # B, N, D, W: digits 5-way 5-shot supports


def check_fused_mll_per_episode(device) -> None:
    """Each episode's own scales [B, W] and diffs [B, W, N] (test-time
    adaptation), kernel against plain version with check_fused_mll's
    limits at the digits adaptation shape and at the main path's N and D;
    and the shared form [W], [W, N] against the per-episode form with
    every episode's rows equal, which must give the same mll, L^-1 and
    alpha bit for bit (the same kernels, the same arithmetic). Times
    kernel, plain version and library call at the adaptation shape."""
    from deep_kernel_transfer_tpu_torch.ops import fused_mll as fm

    main_n = MAIN_WAY * (MAIN_SHOT + MAIN_QUERY)
    for b, n, d, w in (ADAPT_SHAPE, (MAIN_B, main_n, MAIN_D, MAIN_WAY)):
        check(f"fused_mll per-episode params B={b} N={n} D={d} W={w}",
              fused_mll_errors(b, n, d, w, device, per_episode=True),
              FUSED_MLL_LIMITS)
        z, diffs, scales = mll_inputs(b, n, d, w, device)
        shared = fm._forward_cuda(z, diffs, scales, NOISE, 1e-6)
        repeated = fm._forward_cuda(z, diffs.expand(b, -1, -1),
                                    scales.expand(b, -1), NOISE, 1e-6)
        same = [torch.equal(x, y) for x, y in zip(shared[:3], repeated[:3])]
        print(f"fused_mll B={b} N={n}: shared form bit-equal to repeated "
              f"per-episode rows (mll, L^-1, alpha): {same}", flush=True)
        if not all(same):
            raise AssertionError("the shared and per-episode forms differ")
    b, n, d, w = ADAPT_SHAPE
    z, diffs, scales = mll_inputs(b, n, d, w, device, per_episode=True)
    times = ms_in_turns({
        "kernel": lambda: fm.fused_linear_mll(z, diffs, scales, n, NOISE),
        "plain": lambda: fm.fused_linear_mll_plain(z, diffs, scales, n,
                                                   NOISE),
        "library": lambda: library_mll(z, diffs, scales, NOISE)})
    bound = fused_mll_bound_ms(b, n, d, w, per_episode=True)
    print(f"fused_linear_mll per-episode B={b} N={n} D={d} W={w}, median "
          f"(min-max) of turns: " + ", ".join(
              f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) ms"
              for k, v in times.items())
          + f", bound {bound[0]:.6f} ms ({bound[1]})", flush=True)
    # one adaptation step's MLL, forward and backward in the episodes' own
    # parameters: host wall time a step against the device's kernel time
    args = [t.clone().requires_grad_(True) for t in (diffs, scales)]

    def step():
        mll = fm.fused_linear_mll(z, *args, n, NOISE)
        return torch.autograd.grad(-mll.sum(), args)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    dev_ms = print_device_table(
        f"fused_linear_mll per-episode forward+backward B={b} N={n} D={d} "
        f"W={w}", profiled(step))
    print(f"adaptation-step MLL B={b} N={n}: host wall {wall_ms:.4f} ms a "
          f"step against {dev_ms:.4f} ms of kernel time", flush=True)


# The train cells' trunk BatchNorms: (label, episodes, images, C, side,
# ReLU fused, layers of this shape in the step). Conv4 at B = 32,
# ResNet10 at B = 16 and ResNet50 at B = 8, 5w5s16q (105 images an
# episode); ResNet50's 49 are its stem's and each bottleneck's BN1, BN2
# (ReLU fused) and BN3 (the ReLU after the residual add).
BN_SHAPES = (
    ("Conv4 84 px", 32, 3360, 64, 84, True, 1),
    ("Conv4 42 px", 32, 3360, 64, 42, True, 1),
    ("Conv4 21 px", 32, 3360, 64, 21, True, 1),
    ("Conv4 10 px", 32, 3360, 64, 10, True, 1),
    ("ResNet10 stem", 16, 1680, 64, 112, False, 1),
    ("ResNet10 stage 1 BN1", 16, 1680, 64, 56, True, 1),
    ("ResNet10 stage 1 BN2", 16, 1680, 64, 56, False, 1),
    ("ResNet10 stage 2 BN1", 16, 1680, 128, 28, True, 1),
    ("ResNet10 stage 2 BN2, BNshortcut", 16, 1680, 128, 28, False, 2),
    ("ResNet10 stage 3 BN1", 16, 1680, 256, 14, True, 1),
    ("ResNet10 stage 3 BN2, BNshortcut", 16, 1680, 256, 14, False, 2),
    ("ResNet10 stage 4 BN1", 16, 1680, 512, 7, True, 1),
    ("ResNet10 stage 4 BN2, BNshortcut", 16, 1680, 512, 7, False, 2),
    ("ResNet50 stem", 8, 840, 64, 112, False, 1),
    ("ResNet50 stage 1 BN1, BN2", 8, 840, 64, 56, True, 6),
    ("ResNet50 stage 1 BN3", 8, 840, 256, 56, False, 3),
    ("ResNet50 stage 2 first BN1", 8, 840, 128, 56, True, 1),
    ("ResNet50 stage 2 BN1, BN2", 8, 840, 128, 28, True, 7),
    ("ResNet50 stage 2 BN3", 8, 840, 512, 28, False, 4),
    ("ResNet50 stage 3 first BN1", 8, 840, 256, 28, True, 1),
    ("ResNet50 stage 3 BN1, BN2", 8, 840, 256, 14, True, 11),
    ("ResNet50 stage 3 BN3", 8, 840, 1024, 14, False, 6),
    ("ResNet50 stage 4 first BN1", 8, 840, 512, 14, True, 1),
    ("ResNet50 stage 4 BN1, BN2", 8, 840, 512, 7, True, 5),
    ("ResNet50 stage 4 BN3", 8, 840, 2048, 7, False, 3),
)
BN_LIMITS = {"y": 1e-2, "mean": 1e-4, "var": 1e-4, "dx": 1e-2, "dw": 1e-2,
             "db": 1e-2}
BN_BYTES = 10  # bf16: x in, y out; dy and x in, dx out
# Eval-mode BatchNorm shapes (label, images, C, px, relu, layers): Conv4's
# eval batch of 32 5w5s15q episodes, and ResNet50 at 16 such episodes.
EVAL_BN_SHAPES = (
    ("Conv4 84 px", 3200, 64, 84, True, 1),
    ("Conv4 42 px", 3200, 64, 42, True, 1),
    ("Conv4 21 px", 3200, 64, 21, True, 1),
    ("Conv4 10 px", 3200, 64, 10, True, 1),
    ("ResNet50 stage 1 BN3", 1600, 256, 56, False, 3),
    ("ResNet50 stage 4 BN3", 1600, 2048, 7, False, 3),
)
EVAL_BN_BYTES = 4  # bf16: x in, y out
EVAL_POOL_BYTES = 2.5  # bf16: x in, a quarter of it out
PROTOCOL_IMAGES = 600 * 5 * 20  # a 600-episode 5w5s15q protocol


def rel_norm(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / (torch.linalg.vector_norm(b) + 1e-30))


def check_episodic_batchnorm(device) -> dict:
    """The episodic BatchNorm kernels (ops/episodic_batchnorm.py) at every
    trunk BatchNorm shape of the three train cells: forward (y and the
    statistics) and backward (dx and the weight and bias gradients)
    against the plain version, two calls on the same inputs bit-equal,
    and forward+backward timed in turns with the plain version and the
    module's torch route (the f32 chain the kernels replace, as
    `library`), beside the bound of 10 bytes an element at 3.35 TB/s.
    Prints each trunk's sum over its step's BatchNorms and returns the
    Conv4 step's entry."""
    from deep_kernel_transfer_tpu_torch.models.backbones import \
        EpisodicBatchNorm
    from deep_kernel_transfer_tpu_torch.ops import episodic_batchnorm as ebn

    gen = torch.Generator(device=device).manual_seed(17)
    bf16 = torch.bfloat16
    sums = {}
    worst = 0.0
    for label, groups, images, c, px, relu, layers in BN_SHAPES:
        shape = (images, px, px, c)
        x = (torch.randn(shape, generator=gen, device=device) * 1.5
             + 0.3).to(bf16).permute(0, 3, 1, 2)
        dy = torch.randn(shape, generator=gen, device=device).to(
            bf16).permute(0, 3, 1, 2)
        bn = EpisodicBatchNorm(c).to(device)
        with torch.no_grad():
            bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen,
                                                    device=device))
            bn.bias.copy_(0.2 * torch.randn(c, generator=gen, device=device))
        w, b, eps = bn.weight.detach(), bn.bias.detach(), bn.eps

        def kernel():
            y, st = ebn._forward_cuda(x, w, b, groups, eps, relu)
            dx, sm = ebn._backward_cuda(dy, x, st, groups, relu)
            return y, st, dx, sm

        def plain():
            y, st = ebn._forward_plain(x, w, b, groups, eps, relu)
            return (y, st) + ebn._backward_plain(dy, x, w, b, st, groups,
                                                 eps, relu)

        xr = x.detach().requires_grad_(True)

        def torch_route():
            """The module's torch ops (`batchnorm_torch`)."""
            y, _ = ebn.batchnorm_torch(
                xr, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                train=True, groups=groups, eps=eps, momentum=bn.momentum,
                relu=relu)
            torch.autograd.backward(y, dy)

        before = ebn.episodic_batchnorm.launches
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if ebn.episodic_batchnorm.launches != before + 4:
            raise AssertionError("episodic_batchnorm did not launch")
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        y, st, dx, sm = got
        y_p, st_p, dx_p, dw_p, db_p = plain()
        errs = {"y": rel_err(y.float(), y_p.float()),
                "mean": rel_err(st[0], st_p[0]),
                "var": rel_err(st[1], st_p[1]),
                "dx": rel_norm(dx, dx_p),
                "dw": rel_norm(ebn._param_grad(sm[1], w), dw_p),
                "db": rel_norm(ebn._param_grad(sm[0], b), db_p)}
        del got, again, y, st, dx, sm, y_p, st_p, dx_p
        check(f"episodic_batchnorm {label} ({images}x{c}x{px}x{px}, G="
              f"{groups}, relu {relu}), bit-equal twice {same}", errs,
              BN_LIMITS)
        if not same:
            raise AssertionError(f"episodic_batchnorm {label}: two calls "
                                 f"on the same inputs differ")
        worst = max(worst, errs["y"])
        times = ms_in_turns({"kernel": kernel, "plain": plain,
                             "library": torch_route},
                            rounds=3, iters=3, warmup=1)
        bound = images * c * px * px * BN_BYTES / PEAK_BYTES * 1e3
        print(f"episodic_batchnorm {label}, forward+backward, median "
              f"(min-max) of turns: " + ", ".join(
                  f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) ms"
                  for k, v in times.items())
              + f" (library: the module's torch route), bound {bound:.4f} "
              f"ms, kernel at {100 * bound / times['kernel'][0]:.1f}% of it",
              flush=True)
        trunk = label.split()[0]
        acc = sums.setdefault(trunk, {"kernel": 0.0, "plain": 0.0,
                                      "library": 0.0, "bound": 0.0})
        for k in ("kernel", "plain", "library"):
            acc[k] += layers * times[k][0]
        acc["bound"] += layers * bound
        del x, dy, xr, bn
        torch.cuda.empty_cache()
    for trunk, acc in sums.items():
        print(f"episodic_batchnorm: the {trunk} step's BatchNorms, forward+"
              f"backward: kernel {acc['kernel']:.3f} ms, plain "
              f"{acc['plain']:.3f} ms, torch route {acc['library']:.3f} ms, "
              f"bound {acc['bound']:.3f} ms (kernel at "
              f"{100 * acc['bound'] / acc['kernel']:.1f}%)", flush=True)
    acc = sums["Conv4"]
    return {"name": "episodic_batchnorm", "route": "cuda",
            "source": "deep_kernel_transfer_tpu_torch/csrc/"
                      "episodic_batchnorm.cu",
            "replaces": "none: XLA fuses the JAX BatchNorm "
                        "(models/backbones.py:120-139)",
            "launches": None, "max_abs_err": worst, "ms": acc["kernel"],
            "plain_ms": acc["plain"], "bound_ms": acc["bound"],
            "bound_by": "bytes", "library_ms": acc["library"],
            "resnet10_ms": sums["ResNet10"]["kernel"],
            "resnet10_bound_ms": sums["ResNet10"]["bound"],
            "resnet50_ms": sums["ResNet50"]["kernel"],
            "resnet50_bound_ms": sums["ResNet50"]["bound"]}


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(the largest |a - b| / (1e-5 + 2^-7 |b|), at most 1 within a bf16
    rounding; the share of elements that differ) of two bf16 tensors, in
    slices along dim 0."""
    worst, differ = 0.0, 0
    for i in range(0, a.shape[0], 256):
        x, y = a[i:i + 256].float(), b[i:i + 256].float()
        worst = max(worst, float(((x - y).abs() / (1e-5 + 2 ** -7 * y.abs()))
                                 .max()))
        differ += int((x != y).sum())
    return worst, differ / a.numel()


def check_episodic_batchnorm_eval(device) -> dict:
    """The eval-mode BatchNorm(+ReLU) kernel (ops/episodic_batchnorm.py::
    episodic_batchnorm_eval) through the module's eval route under
    no_grad, at Conv4's eval batch (3200 images, 84/42/21/10 px, C = 64,
    ReLU) and ResNet50's C = 256 at 56 px and C = 2048 at 7 px (1600
    images, no ReLU): against the module's eval torch route and the plain
    version within a bf16 rounding, two calls bit-equal, one eval launch
    a call and none left to torch, and ms a call by CUDA events in turns
    with the torch route, beside the bound of 4 bytes an element at 3.35
    TB/s. Prints the Conv4 batch's and protocol's sums and returns the
    Conv4 batch's entry."""
    from deep_kernel_transfer_tpu_torch.models.backbones import \
        EpisodicBatchNorm
    from deep_kernel_transfer_tpu_torch.ops import episodic_batchnorm as ebn

    gen = torch.Generator(device=device).manual_seed(19)
    counter = ebn.episodic_batchnorm
    sums = {}
    worst = 0.0
    for label, images, c, px, relu, layers in EVAL_BN_SHAPES:
        x = (torch.randn((images, px, px, c), generator=gen, device=device)
             * 1.5 + 0.3).to(torch.bfloat16).permute(0, 3, 1, 2)
        bn = EpisodicBatchNorm(c).to(device)
        with torch.no_grad():
            bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen,
                                                    device=device))
            bn.bias.copy_(0.2 * torch.randn(c, generator=gen, device=device))
            bn.running_mean.copy_(0.3 + 0.1 * torch.randn(
                c, generator=gen, device=device))
            bn.running_var.copy_(2.25 * (1.0 + 0.1 * torch.rand(
                c, generator=gen, device=device)))

        @torch.no_grad()
        def kernel():
            return bn(x, False, 1, None, relu=relu)

        @torch.no_grad()
        def torch_route():
            """The module's eval torch ops (`batchnorm_torch`)."""
            return ebn.batchnorm_torch(
                x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                train=False, eps=bn.eps, relu=relu)[0]

        counter.eval_launches = counter.eval_torch_route = 0
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        counts = (counter.eval_launches, counter.eval_torch_route)
        same = torch.equal(got, again)
        del again
        want = torch_route()
        with torch.no_grad():
            plain = ebn._eval_plain(x, bn.weight, bn.bias, bn.running_mean,
                                    bn.running_var, bn.eps, relu)
        (ulps, differ), (ulps_p, differ_p) = (ulps_apart(got, want),
                                              ulps_apart(got, plain))
        del got, want, plain
        print(f"episodic_batchnorm_eval {label} ({images}x{c}x{px}x{px}, "
              f"relu {relu}): against the torch route {ulps:.3f} of a bf16 "
              f"rounding at most, {100 * differ:.4f}% of elements differ; "
              f"against the plain version {ulps_p:.3f}, {100 * differ_p:.4f}"
              f"%; bit-equal twice {same}; eval launches {counts[0]} (want "
              f"2), eval torch route {counts[1]}", flush=True)
        if not same or counts != (2, 0) or max(ulps, ulps_p) > 1.0:
            raise AssertionError(f"episodic_batchnorm_eval {label} failed")
        worst = max(worst, ulps)
        times = ms_in_turns({"kernel": kernel, "library": torch_route},
                            rounds=3, iters=5, warmup=1)
        bound = images * c * px * px * EVAL_BN_BYTES / PEAK_BYTES * 1e3
        print(f"episodic_batchnorm_eval {label}, median (min-max) of turns: "
              + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) ms"
                          for k, v in times.items())
              + f" (library: the module's eval torch route), bound "
              f"{bound:.4f} ms, kernel at {100 * bound / times['kernel'][0]:.1f}"
              f"% of it", flush=True)
        acc = sums.setdefault(label.split()[0], {"kernel": 0.0,
                                                 "library": 0.0,
                                                 "bound": 0.0})
        for k in ("kernel", "library"):
            acc[k] += layers * times[k][0]
        acc["bound"] += layers * bound
        del x, bn
        torch.cuda.empty_cache()
    acc = sums["Conv4"]
    per_protocol = PROTOCOL_IMAGES / EVAL_BN_SHAPES[0][1]
    print(f"episodic_batchnorm_eval: Conv4's eval batch of 3200 images: "
          f"kernel {acc['kernel']:.3f} ms, torch route {acc['library']:.3f} "
          f"ms, bound {acc['bound']:.3f} ms (kernel at "
          f"{100 * acc['bound'] / acc['kernel']:.1f}%); a 600-episode "
          f"protocol: kernel {per_protocol * acc['kernel']:.1f} ms, torch "
          f"route {per_protocol * acc['library']:.1f} ms, bound "
          f"{per_protocol * acc['bound']:.1f} ms", flush=True)
    return {"name": "episodic_batchnorm_eval", "route": "cuda",
            "source": "deep_kernel_transfer_tpu_torch/csrc/"
                      "episodic_batchnorm.cu",
            "replaces": "none: XLA fuses the JAX BatchNorm "
                        "(models/backbones.py:120-139)",
            "launches": None, "max_abs_err": worst, "ms": acc["kernel"],
            "bound_ms": acc["bound"], "bound_by": "bytes",
            "library_ms": acc["library"],
            "resnet50_ms": sums["ResNet50"]["kernel"],
            "resnet50_bound_ms": sums["ResNet50"]["bound"]}


def check_episodic_batchnorm_eval_pool(device) -> dict:
    """The eval ConvBlock epilogue (`episodic_bn_eval_epilogue` through the
    module's `EpisodicBatchNorm.eval_epilogue`, the route of an eval
    ConvBlock on the card) at Conv4's eval batch (3200 images, 84/42/21/10
    px, C = 64, a conv output made without its bias, which the pass adds)
    against today's chain on the card (the bias added in bf16, as ATen adds
    it after cuDNN, the eval kernel's BN+ReLU, max_pool2d): bit-equal to
    it, within one bf16 rounding of the plain version, two calls
    bit-equal, one pooled launch a call and no other; ms a call by CUDA
    events in turns with the chain, beside the bound of 2.5 bytes an
    element at 3.35 TB/s. Unpooled (a block that does not pool) the same
    pass against the bias add and the eval kernel, bit-equal, one eval
    launch. Prints the batch's and the protocol's sums and returns the
    batch's entry."""
    import torch.nn.functional as F

    from deep_kernel_transfer_tpu_torch.models.backbones import \
        EpisodicBatchNorm
    from deep_kernel_transfer_tpu_torch.ops import episodic_batchnorm as ebn

    gen = torch.Generator(device=device).manual_seed(23)
    counter = ebn.episodic_batchnorm
    names = ("eval_pool_launches", "eval_launches", "eval_torch_route",
             "copies")
    acc = {"kernel": 0.0, "library": 0.0, "bound": 0.0}
    worst = 0.0
    for label, images, c, px, relu, layers in EVAL_BN_SHAPES[:4]:
        x = (torch.randn((images, px, px, c), generator=gen, device=device)
             * 1.5 + 0.3).to(torch.bfloat16).permute(0, 3, 1, 2)
        conv_bias = 0.4 * torch.randn(c, generator=gen, device=device)
        bn = EpisodicBatchNorm(c).to(device)
        with torch.no_grad():
            sign = torch.where(torch.arange(c, device=device) % 3 == 1,
                               -1.0, 1.0)
            bn.weight.copy_(sign * (1.0 + 0.3 * torch.rand(
                c, generator=gen, device=device)))
            bn.bias.copy_(0.2 * torch.randn(c, generator=gen, device=device))
            bn.running_mean.copy_(0.3 + 0.1 * torch.randn(
                c, generator=gen, device=device))
            bn.running_var.copy_(2.25 * (1.0 + 0.1 * torch.rand(
                c, generator=gen, device=device)))
        bias16 = conv_bias.to(torch.bfloat16).view(1, c, 1, 1)

        @torch.no_grad()
        def kernel(pool=True):
            return bn.eval_epilogue(x, conv_bias, pool)

        @torch.no_grad()
        def chain(pool=True):
            """Today's chain: the bias add, the eval BN+ReLU, the pool."""
            y = bn(x + bias16, False, 1, None, relu=relu)
            return F.max_pool2d(y, 2, 2) if pool else y

        for pool in (True, False):
            for name in names:
                setattr(counter, name, 0)
            got, again = kernel(pool), kernel(pool)
            torch.cuda.synchronize()
            counts = tuple(getattr(counter, name) for name in names)
            same = torch.equal(got, again)
            del again
            want = chain(pool)
            with torch.no_grad():
                plain = (ebn._eval_pool_plain if pool else ebn._eval_plain)(
                    x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                    bn.eps, relu, conv_bias)
            equal = torch.equal(got, want)
            ulps, differ = ulps_apart(got, want)
            ulps_p, differ_p = ulps_apart(got, plain)
            del got, want, plain
            kind = "pooled" if pool else "unpooled"
            print(f"episodic_batchnorm_eval {kind} {label} ({images}x{c}x"
                  f"{px}x{px}, conv bias added in the pass): against the "
                  f"chain bit-equal {equal}, {ulps:.3f} of a bf16 rounding "
                  f"at most, {100 * differ:.4f}% of elements differ; against "
                  f"the plain version {ulps_p:.3f}, {100 * differ_p:.4f}%; "
                  f"bit-equal twice {same}; pooled launches, eval launches, "
                  f"eval torch route, copies {counts} (want "
                  f"({2 * pool}, {2 * (not pool)}, 0, 0))", flush=True)
            if (not (same and equal) or ulps_p > 1.0
                    or counts != (2 * pool, 2 * (not pool), 0, 0)):
                raise AssertionError(f"episodic_batchnorm_eval {kind} "
                                     f"{label} failed")
            worst = max(worst, ulps)
        times = ms_in_turns({"kernel": kernel, "library": chain},
                            rounds=3, iters=5, warmup=1)
        bound = images * c * px * px * EVAL_POOL_BYTES / PEAK_BYTES * 1e3
        print(f"episodic_batchnorm_eval pooled {label}, median (min-max) of "
              f"turns: " + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f})"
                                     f" ms" for k, v in times.items())
              + f" (library: bias add, eval BN+ReLU, max_pool2d), bound "
              f"{bound:.4f} ms, kernel at {100 * bound / times['kernel'][0]:.1f}"
              f"% of it", flush=True)
        for k in ("kernel", "library"):
            acc[k] += layers * times[k][0]
        acc["bound"] += layers * bound
        del x, bn
        torch.cuda.empty_cache()
    per_protocol = PROTOCOL_IMAGES / EVAL_BN_SHAPES[0][1]
    print(f"episodic_batchnorm_eval pooled: Conv4's eval batch of 3200 "
          f"images: kernel {acc['kernel']:.3f} ms, chain {acc['library']:.3f}"
          f" ms, bound {acc['bound']:.3f} ms (kernel at "
          f"{100 * acc['bound'] / acc['kernel']:.1f}%); a 600-episode "
          f"protocol: kernel {per_protocol * acc['kernel']:.1f} ms, chain "
          f"{per_protocol * acc['library']:.1f} ms, bound "
          f"{per_protocol * acc['bound']:.1f} ms", flush=True)
    return {"name": "episodic_batchnorm_eval_pool", "route": "cuda",
            "source": "deep_kernel_transfer_tpu_torch/csrc/"
                      "episodic_batchnorm.cu",
            "replaces": "none: XLA fuses the JAX ConvBlock's bias, "
                        "BatchNorm, ReLU and pool (models/backbones.py:"
                        "120-139, 159-181)",
            "launches": None, "max_abs_err": worst, "ms": acc["kernel"],
            "bound_ms": acc["bound"], "bound_by": "bytes",
            "library_ms": acc["library"]}


def spd_matrix(b: int, n: int, device) -> torch.Tensor:
    """z z^T + 0.5 I with z [B, N, N/2] (tests/test_pallas_mll.py:88-90)."""
    z = np.random.RandomState(n).randn(b, n, n // 2).astype(np.float32)
    z = torch.from_numpy(z).to(device)
    return z @ z.mT + 0.5 * torch.eye(n, device=device)


def unit_rows(b: int, n: int, d: int, device, seed: int = 0) -> torch.Tensor:
    """Features with unit-norm rows, as bncossim gives and the memory demo
    uses."""
    z = np.random.RandomState(seed + n).randn(b, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return torch.from_numpy(z).to(device)


def logdet_of(chol: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum()


def grads_of(fn, args) -> tuple:
    """Gradients of logdet(fn(*args)) in every tensor argument."""
    args = [a.detach().clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(logdet_of(fn(*args)), args)


def launched_once(counter, fn):
    """fn() on the card; raises unless `counter` (a wrapper) launched its
    kernel exactly once."""
    before = counter.launches
    out = fn()
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise AssertionError(f"{counter.__name__} did not launch its kernel")
    return out


def kernel_entry(name: str, source: str, replaces: str, err: float,
                 times: dict, bound: tuple[float, str], shape: str,
                 ffma_bound: tuple[float, str] | None = None) -> dict:
    """The kernel's JSON entry. `bound` is at the rate of the kernel's own
    arithmetic; `ffma_bound`, printed beside it, at the f32 FFMA rate."""
    print(f"{name} {shape}, median (min-max) of turns: " + ", ".join(
        f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) ms" for k, v in times.items())
        + f", bound {bound[0]:.4f} ms ({bound[1]})" + (
            f", f32 FFMA bound {ffma_bound[0]:.4f} ms" if ffma_bound else ""),
        flush=True)
    return {"name": name, "route": "cuda",
            "source": f"deep_kernel_transfer_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": times["kernel"][0], "plain_ms": times["plain"][0],
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": times["library"][0]}


def check(label: str, errs: dict, limits: dict) -> None:
    print(f"{label}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
          flush=True)
    for k, v in errs.items():
        if not v < limits[k]:
            raise AssertionError(f"{label}: {k} {v:.3e} >= {limits[k]}")


def check_blocked_cholesky(device) -> dict:
    """Kernel against plain version, B=8 at N in {128, 256, 512}: factor
    and reconstruction 1e-5 relative, an exactly zero upper triangle, the
    logdet gradient 2e-2 relative to stock autograd; N=50 takes the stock
    Cholesky with no launch. Timed at B=8, N=512."""
    from deep_kernel_transfer_tpu_torch.ops.blocked_cholesky import (
        blocked_cholesky, blocked_cholesky_plain)

    limits = {"factor": 1e-5, "reconstruction": 1e-5, "upper": 1e-30,
              "grad": 2e-2}
    for n in (128, 256, 512):
        k = spd_matrix(8, n, device)
        got = launched_once(blocked_cholesky, lambda: blocked_cholesky(k))
        want = blocked_cholesky_plain(k)
        errs = {"factor": rel_err(got, want),
                "reconstruction": rel_err(got @ got.mT, k),
                "upper": float(torch.triu(got, 1).abs().max()),
                "grad": rel_err(grads_of(blocked_cholesky, [k])[0],
                                grads_of(torch.linalg.cholesky, [k])[0])}
        check(f"blocked_cholesky B=8 N={n}", errs, limits)
    fwd_err = float((got - want).abs().max())
    k50 = spd_matrix(8, 50, device)
    before = blocked_cholesky.launches
    err50 = float((blocked_cholesky(k50) - torch.linalg.cholesky(k50)
                   ).abs().max())
    torch.cuda.synchronize()
    print(f"blocked_cholesky N=50: stock route, max abs err {err50:.3e}, "
          f"launches {blocked_cholesky.launches - before}", flush=True)
    if blocked_cholesky.launches != before or not err50 < 1e-5:
        raise AssertionError("blocked_cholesky N=50 must take the stock route")
    times = ms_in_turns({"kernel": lambda: blocked_cholesky(k),
                         "plain": lambda: blocked_cholesky_plain(k),
                         "library": lambda: torch.linalg.cholesky(k)})
    return kernel_entry(
        "blocked_cholesky", "blocked_cholesky.cu",
        "deep_kernel_transfer_tpu/ops/pallas/blocked_cholesky.py:154",
        fwd_err, times, cholesky_bound_ms(8, 512), "B=8 N=512",
        cholesky_bound_ms(8, 512, PEAK_F32_FLOPS))


def check_hbm_cholesky(device) -> dict:
    """Kernel against plain version, K = 2 Z Z^T, diag 0.1, B=2 at N in
    {384, 1024, 2048}: factor 1e-5 relative, gradients in K and diag 2e-2
    relative to stock autograd. Timed at B=2, N=2048."""
    from deep_kernel_transfer_tpu_torch.ops.hbm_cholesky import (
        hbm_blocked_cholesky, hbm_blocked_cholesky_plain)

    def stock(kk, dd):
        return torch.linalg.cholesky(
            kk + dd * torch.eye(kk.shape[-1], device=device))

    diag = torch.tensor(0.1, device=device)
    for n in (384, 1024, 2048):
        z = unit_rows(2, n, 256, device)
        k = 2.0 * (z @ z.mT)
        got = launched_once(hbm_blocked_cholesky,
                            lambda: hbm_blocked_cholesky(k, 0.1))
        want = hbm_blocked_cholesky_plain(k, 0.1)
        g_kernel = grads_of(hbm_blocked_cholesky, [k, diag])
        g_stock = grads_of(stock, [k, diag])
        errs = {"factor": rel_err(got, want),
                "upper": float(torch.triu(got, 1).abs().max()),
                "grad K": rel_err(g_kernel[0], g_stock[0]),
                "grad diag": rel_err(g_kernel[1], g_stock[1])}
        check(f"hbm_blocked_cholesky B=2 N={n}", errs,
              {"factor": 1e-5, "upper": 1e-30, "grad K": 2e-2,
               "grad diag": 2e-2})
    times = ms_in_turns({"kernel": lambda: hbm_blocked_cholesky(k, 0.1),
                         "plain": lambda: hbm_blocked_cholesky_plain(k, 0.1),
                         "library": lambda: stock(k, 0.1)})
    return kernel_entry(
        "hbm_blocked_cholesky", "hbm_cholesky.cu",
        "deep_kernel_transfer_tpu/ops/pallas/hbm_cholesky.py:283",
        float((got - want).abs().max()), times, cholesky_bound_ms(2, 2048),
        "B=2 N=2048", cholesky_bound_ms(2, 2048, PEAK_F32_FLOPS))


def library_gram_cholesky(z, scale, diag):
    """torch.matmul (TF32 off) + in-place diagonal + torch.linalg.cholesky:
    the yardstick, never used by the port."""
    k = z @ z.mT
    k.mul_(scale)
    k.diagonal(dim1=-2, dim2=-1).add_(diag)
    return torch.linalg.cholesky(k)


def check_fused_gram_cholesky(device) -> dict:
    """Kernel against plain version, scale 2, diag 0.1, B=2, D=256 at N in
    {384, 2048}: factor 1e-5 relative, gradients in Z, scale and diag 2e-2
    relative to stock autograd. Timed at B=2, N=2048, D=256."""
    from deep_kernel_transfer_tpu_torch.ops.hbm_cholesky import (
        fused_gram_cholesky, fused_gram_cholesky_plain)

    def stock(zz, s, dd):
        return torch.linalg.cholesky(
            s * (zz @ zz.mT) + dd * torch.eye(zz.shape[1], device=device))

    sd = [torch.tensor(2.0, device=device), torch.tensor(0.1, device=device)]
    for n in (384, 2048):
        z = unit_rows(2, n, 256, device)
        got = launched_once(fused_gram_cholesky,
                            lambda: fused_gram_cholesky(z, 2.0, 0.1))
        want = fused_gram_cholesky_plain(z, 2.0, 0.1)
        g_kernel = grads_of(fused_gram_cholesky, [z, *sd])
        g_stock = grads_of(stock, [z, *sd])
        errs = {"factor": rel_err(got, want),
                "upper": float(torch.triu(got, 1).abs().max())}
        errs.update({f"grad {k}": rel_err(a, b) for k, a, b in zip(
            ("Z", "scale", "diag"), g_kernel, g_stock)})
        check(f"fused_gram_cholesky B=2 N={n} D=256", errs,
              {"factor": 1e-5, "upper": 1e-30, "grad Z": 2e-2,
               "grad scale": 2e-2, "grad diag": 2e-2})
    times = ms_in_turns({
        "kernel": lambda: fused_gram_cholesky(z, 2.0, 0.1),
        "plain": lambda: fused_gram_cholesky_plain(z, 2.0, 0.1),
        "library": lambda: library_gram_cholesky(z, 2.0, 0.1)})
    return kernel_entry(
        "fused_gram_cholesky", "hbm_cholesky.cu",
        "deep_kernel_transfer_tpu/ops/pallas/hbm_cholesky.py:283",
        float((got - want).abs().max()), times,
        fused_gram_bound_ms(2, 2048, 256), "B=2 N=2048 D=256",
        fused_gram_bound_ms(2, 2048, 256, rate=PEAK_F32_FLOPS))


def check_fused_gram_cholesky_tiled(device) -> dict:
    """The tiled kernel + tiled_log_det at B=1, N=32768, D=256. The lower
    tiles of the factor: 1e-4 relative to the stock factor (assemble, then
    cuSOLVER), and 5e-4 relative to the plain version (the same
    left-looking algorithm in torch ops), which is itself 2.1e-4 from the
    stock factor on an H100: K = 2 Z Z^T + 0.1 I has cond(K) = 3e3
    (eigenvalues 0.1 to about 300), so two f32 routes may differ by
    cond(K) eps = 2e-4. The logdet: 1e-3 relative to the plain version and
    to the memory demo's plain arm, the demo's own parity limit (a sum of
    32768 f32 logs)."""
    from deep_kernel_transfer_tpu_torch.benchmarks import hbm_memory_demo
    from deep_kernel_transfer_tpu_torch.ops.hbm_cholesky import (
        fused_gram_cholesky_tiled, fused_gram_cholesky_tiled_plain,
        tile_matrix, tiled_log_det)

    n = 32768
    z = hbm_memory_demo.make_z(n, 256, 0, device)
    got = launched_once(fused_gram_cholesky_tiled,
                        lambda: fused_gram_cholesky_tiled(z, 2.0, 0.1))
    want = fused_gram_cholesky_tiled_plain(z, 2.0, 0.1)
    lower = torch.ones(n // 128, n // 128, device=device).tril().bool()
    got_lower, want_lower = got[0][lower], want[0][lower]
    fwd_err = float((got_lower - want_lower).abs().max())
    ld, ld_plain = tiled_log_det(got), tiled_log_det(want)
    del got, want
    stock = tile_matrix(library_gram_cholesky(z, 2.0, 0.1))[0][lower]
    errs = {"factor vs plain": rel_err(got_lower, want_lower),
            "factor vs stock": rel_err(got_lower, stock),
            "plain vs stock": rel_err(want_lower, stock),
            "logdet vs plain": rel_err(ld, ld_plain),
            "logdet vs plain arm": rel_err(ld, hbm_memory_demo.logdet_plain(z))}
    del got_lower, want_lower, stock
    check(f"fused_gram_cholesky_tiled B=1 N={n} D=256, logdet "
          f"{float(ld[0])!r}, factor max abs err {fwd_err:.3e}", errs,
          {"factor vs plain": 5e-4, "factor vs stock": 1e-4,
           "plain vs stock": math.inf, "logdet vs plain": 1e-3,
           "logdet vs plain arm": 1e-3})
    times = ms_in_turns({
        "kernel": lambda: fused_gram_cholesky_tiled(z, 2.0, 0.1),
        "plain": lambda: fused_gram_cholesky_tiled_plain(z, 2.0, 0.1),
        "library": lambda: library_gram_cholesky(z, 2.0, 0.1)},
        rounds=3, iters=1, warmup=1)
    return kernel_entry(
        "fused_gram_cholesky_tiled", "hbm_cholesky.cu",
        "deep_kernel_transfer_tpu/ops/pallas/hbm_cholesky.py:283", fwd_err,
        times, fused_gram_bound_ms(1, n, 256, tiled=True), f"B=1 N={n} D=256",
        fused_gram_bound_ms(1, n, 256, tiled=True, rate=PEAK_F32_FLOPS))


def profiled(fn, activities=None):
    """fn() once under torch.profiler (device activity only by default),
    synchronised; returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=activities or [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def print_device_table(label: str, prof) -> float:
    """Device ms and launches by kernel name (template instantiations
    apart), the device's busy time and the idle gaps between the first
    launch and the end of the last; returns the kernels' device ms."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        name = e.name.removeprefix("void ").replace(
            "(anonymous namespace)::", "").split("(")[0]
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    # busy: the union of the kernels' intervals (launches may overlap)
    busy, end = 0.0, -math.inf
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy, end = busy + max(hi - lo, 0) / 1e3, max(end, hi)
    span = (end - min(e.time_range.start for e in kernels)) / 1e3
    total = sum(ms for ms, _ in by_name.values())
    print(f"profile {label}: {len(kernels)} launches, kernel time "
          f"{total:.4f} ms, device busy {busy:.4f} ms of a {span:.4f} ms "
          f"span (gaps {span - busy:.4f} ms)", flush=True)
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:10.4f} ms {count:6d} launches  {name}", flush=True)
    return total


def profile_fused_mll(device) -> list[str]:
    """torch.profiler over one forward and one backward of the fused MLL at
    the main path's shape, after a warm-up: device ms and launches by
    kernel for each, the forward's share of the GP tail's device time, and
    the torch ops of the backward. Returns the backward's op and kernel
    names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    n = MAIN_WAY * (MAIN_SHOT + MAIN_QUERY)
    z, diffs, scales = mll_inputs(MAIN_B, n, MAIN_D, MAIN_WAY, device)
    args = [t.clone().requires_grad_(True) for t in (z, diffs, scales)]
    shape = f"B={MAIN_B} N={n} D={MAIN_D} W={MAIN_WAY}"

    def forward():
        return fused_linear_mll(*args, n, NOISE)

    ones = torch.ones(MAIN_B, MAIN_WAY, device=device)
    torch.autograd.grad(forward(), args, ones)
    out = []
    fwd = profiled(lambda: out.append(forward()))
    bwd = profiled(lambda: torch.autograd.grad(out[0], args, ones),
                   [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    fwd_ms = print_device_table(f"fused_linear_mll forward {shape}", fwd)
    bwd_ms = print_device_table(f"fused_linear_mll backward {shape}", bwd)
    ops = {}
    for e in bwd.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("aten::"):
            ops[e.name] = ops.get(e.name, 0) + 1
    print(f"GP tail {shape}: forward (the kernel) {fwd_ms:.4f} ms, backward "
          f"{bwd_ms:.4f} ms of device time, the kernel "
          f"{100 * fwd_ms / (fwd_ms + bwd_ms):.1f}%; the backward's torch "
          f"ops: " + ", ".join(f"{k} x{v}" for k, v in sorted(ops.items())),
          flush=True)
    return list(ops) + [e.name for e in bwd.events()
                        if e.device_type == DeviceType.CUDA]


def profile_cholesky(device) -> None:
    """torch.profiler over one call of each Cholesky kernel at its timed
    shape, after one warm-up call: device ms and launches by kernel (see
    print_device_table)."""
    from deep_kernel_transfer_tpu_torch.benchmarks import hbm_memory_demo
    from deep_kernel_transfer_tpu_torch.ops.blocked_cholesky import (
        blocked_cholesky)
    from deep_kernel_transfer_tpu_torch.ops.hbm_cholesky import (
        fused_gram_cholesky, fused_gram_cholesky_tiled, hbm_blocked_cholesky)

    k512 = spd_matrix(8, 512, device)
    z2048 = unit_rows(2, 2048, 256, device)
    k2048 = 2.0 * (z2048 @ z2048.mT)
    z32k = hbm_memory_demo.make_z(32768, 256, 0, device)
    calls = {
        "blocked_cholesky B=8 N=512": lambda: blocked_cholesky(k512),
        "hbm_blocked_cholesky B=2 N=2048":
            lambda: hbm_blocked_cholesky(k2048, 0.1),
        "fused_gram_cholesky B=2 N=2048 D=256":
            lambda: fused_gram_cholesky(z2048, 2.0, 0.1),
        "fused_gram_cholesky_tiled B=1 N=32768 D=256":
            lambda: fused_gram_cholesky_tiled(z32k, 2.0, 0.1)}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        print_device_table(label, profiled(fn))


def drive_gp_memory_path(device) -> dict:
    """The GP engine's large-support-set path through the port's entry
    points, at the JAX benchmark's shapes (benchmarks/run_all.py:370-413)
    and the memory demo's: logdets (and their gradients where the entry
    point has one) of blocked_cholesky at B=8, N in {256, 512};
    hbm_blocked_cholesky at B=2, N=2048; fused_gram_cholesky at B=2, N in
    {1024, 2048}, D=256; and the demo's fused arm at N=32768. Returns each
    kernel's launch count over that run."""
    from deep_kernel_transfer_tpu_torch.benchmarks import hbm_memory_demo
    from deep_kernel_transfer_tpu_torch.ops.blocked_cholesky import (
        blocked_cholesky)
    from deep_kernel_transfer_tpu_torch.ops.hbm_cholesky import (
        fused_gram_cholesky, fused_gram_cholesky_tiled, hbm_blocked_cholesky)

    inputs = {"blocked": [spd_matrix(8, n, device) for n in (256, 512)],
              "hbm": 2.0 * (lambda z: z @ z.mT)(unit_rows(2, 2048, 256,
                                                          device)),
              "fused": [unit_rows(2, n, 256, device) for n in (1024, 2048)],
              "demo": hbm_memory_demo.make_z(32768, 256, 0, device)}
    counters = (blocked_cholesky, hbm_blocked_cholesky, fused_gram_cholesky,
                fused_gram_cholesky_tiled)
    for c in counters:
        c.launches = 0
    values = []
    for k in inputs["blocked"]:
        values += [logdet_of(blocked_cholesky(k)),
                   grads_of(blocked_cholesky, [k])[0]]
    values += [logdet_of(hbm_blocked_cholesky(inputs["hbm"], 0.1)),
               *grads_of(hbm_blocked_cholesky,
                         [inputs["hbm"], torch.tensor(0.1, device=device)])]
    for z in inputs["fused"]:
        values += [logdet_of(fused_gram_cholesky(z, 2.0, 0.1)),
                   *grads_of(fused_gram_cholesky,
                             [z, torch.tensor(2.0, device=device),
                              torch.tensor(0.1, device=device)])]
    demo_logdet = hbm_memory_demo.logdet_fused(inputs["demo"])
    values.append(demo_logdet)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    print(f"GP memory-regime path: launches {launches}, demo logdet at "
          f"N=32768 {float(demo_logdet[0])!r}", flush=True)
    if not all(bool(torch.isfinite(v).all()) for v in values):
        raise AssertionError("non-finite logdet or gradient on the GP path")
    want = {"blocked_cholesky": 4, "hbm_blocked_cholesky": 2,
            "fused_gram_cholesky": 4, "fused_gram_cholesky_tiled": 1}
    if launches != want:
        raise AssertionError(f"want launches {want}, got {launches}")
    return launches


def check_batchnorm_route(label: str, steps: int, layers: int) -> int:
    """Every 4-D bf16 training BatchNorm of `steps` train steps took the
    kernels: one forward and one backward entry call a layer a step, none
    left to torch, no layout copy (counted from 0 by the caller). Returns
    the launches."""
    from deep_kernel_transfer_tpu_torch.ops.episodic_batchnorm import \
        episodic_batchnorm as ebn

    got = (ebn.launches, ebn.torch_route, ebn.copies)
    print(f"{label}: episodic_batchnorm launches {got[0]} (want {steps} "
          f"steps x {layers} layers x 2), torch route {got[1]}, layout "
          f"copies {got[2]}", flush=True)
    if got != (2 * steps * layers, 0, 0):
        raise AssertionError(f"{label}: the trunk's BatchNorms did not all "
                             f"take the kernels once each way: {got}")
    return got[0]


def reset_batchnorm_counts() -> None:
    from deep_kernel_transfer_tpu_torch.ops.episodic_batchnorm import \
        episodic_batchnorm as ebn

    ebn.launches = ebn.torch_route = ebn.copies = 0
    ebn.eval_launches = ebn.eval_torch_route = ebn.eval_pool_launches = 0


def check_eval_batchnorm_route(label: str, batches: int, pooled: int,
                               unpooled: int) -> tuple[int, int]:
    """Every 4-D bf16 eval BatchNorm of `batches` eval batches took an eval
    kernel: a pooled ConvBlock's the pooled pass, every other the eval
    apply, one launch a layer a batch; none left to torch, no layout copy
    and no training kernel (counted from 0 by the caller). Returns (eval
    launches, pooled launches)."""
    from deep_kernel_transfer_tpu_torch.ops.episodic_batchnorm import \
        episodic_batchnorm as ebn

    got = (ebn.eval_pool_launches, ebn.eval_launches, ebn.eval_torch_route,
           ebn.copies, ebn.launches, ebn.torch_route)
    print(f"{label}: episodic_batchnorm pooled eval launches {got[0]} (want "
          f"{batches} batches x {pooled} layers), eval launches {got[1]} "
          f"(want {batches} x {unpooled}), eval torch route {got[2]}, layout "
          f"copies {got[3]}, training launches {got[4]}, training torch "
          f"route {got[5]}", flush=True)
    if got != (batches * pooled, batches * unpooled, 0, 0, 0, 0):
        raise AssertionError(f"{label}: the trunk's eval BatchNorms did not "
                             f"all take the eval kernels: {got}")
    return got[1], got[0]


def drive_main_path(device, card: str) -> tuple[dict, float]:
    """5 DKT meta-training steps at full width through the fused kernel.
    Returns each kernel's launch count over those steps and the fused
    route's train-step ms."""
    from deep_kernel_transfer_tpu_torch.methods import DKT
    from deep_kernel_transfer_tpu_torch.models import Conv4
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    gen = torch.Generator(device=device).manual_seed(0)
    shape = (MAIN_B, MAIN_WAY, MAIN_SHOT + MAIN_QUERY, MAIN_PX, MAIN_PX, 3)
    batches = [torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8) for _ in range(2)]

    def build(fused: bool):
        return DKT(Conv4(), MAIN_WAY, MAIN_SHOT, kernel_type="bncossim",
                   feature_dtype="bfloat16", use_fused_mll=fused,
                   device=device).init(batches[0][0],
                                       torch.Generator().manual_seed(0))

    model = build(True)
    plain = build(False)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        plain_loss = plain.batch_loss_train(batches[0])[0].item()

    fused_linear_mll.launches = 0
    reset_batchnorm_counts()
    losses = [model.train_step(batches[i % 2])["loss"] for i in range(5)]
    torch.cuda.synchronize()
    launches = {"fused_linear_mll": fused_linear_mll.launches,
                "episodic_batchnorm": check_batchnorm_route("main path", 5, 4)}
    losses = [float(v) for v in losses]
    print(f"main path: 5 train steps (Conv4, bncossim, {MAIN_WAY}w"
          f"{MAIN_SHOT}s{MAIN_QUERY}q, {MAIN_PX} px, B={MAIN_B}, bf16 trunk)"
          f", losses {losses}, fused_linear_mll launches {launches}",
          flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if launches["fused_linear_mll"] != 5:
        raise AssertionError(f"want one kernel launch per step: {launches}")
    step1_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print(f"step 1 loss: fused route {losses[0]!r}, plain route "
          f"{plain_loss!r}, relative difference {step1_rel:.3e}", flush=True)
    if step1_rel >= 1e-4:
        raise AssertionError("fused route disagrees with the plain route")

    reset_batchnorm_counts()
    acc = model.batch_correct(batches[1])
    torch.cuda.synchronize()
    (launches["episodic_batchnorm_eval"],
     launches["episodic_batchnorm_eval_pool"]) = check_eval_batchnorm_route(
        "main path eval batch", 1, 4, 0)
    if acc.shape != (MAIN_B,) or not bool(((acc >= 0) & (acc <= 100)).all()):
        raise AssertionError(f"bad accuracies {acc}")
    print(f"batch_correct: mean query accuracy {float(acc.mean()):.2f}% over "
          f"{MAIN_B} episodes (random weights)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    times = ms_in_turns({"fused": lambda: model.train_step(batches[0]),
                         "plain": lambda: plain.train_step(batches[0])},
                        rounds=4, iters=5)
    for name, (ms, lo, hi) in times.items():
        print(f"train step, {name} route: {ms:.3f} ms (median of 4 turns, "
              f"{lo:.3f}-{hi:.3f}), {MAIN_B / ms * 1e3:.1f} episodes/s "
              f"[{card}]", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    profile_step(lambda: model.train_step(batches[0]))
    return launches, times["fused"][0]


def profile_step(step, top: int = 15) -> None:
    """torch.profiler over two fused-route train steps: the device time by
    kernel, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile of 2 train steps: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for e in rows[:top]:
        print(f"  {e.self_device_time_total / 2e3:9.3f} ms/step "
              f"{e.count // 2:5d} calls/step  {e.key[:110]}", flush=True)


# -- the CLI path ------------------------------------------------------------

CLI_SPLITS = (("base", 64), ("val", 16), ("novel", 20))  # miniImagenet
CLI_IMAGES, CLI_PX, CLI_CROP = 600, 96, 84  # 96 = int(84 * 1.15)
CLI_ARGS = ["--dataset=miniImagenet", "--model=Conv4", "--method=DKT",
            "--train_aug", "--episode_batch=32"]


def class_images(c: int, n: int, px: int = CLI_PX) -> np.ndarray:
    """n images [n, px, px, 3] uint8 of class c: noise in [0, 96) and the
    class signature, a block 150 brighter at cell c of a 10x10 grid that
    lies inside the centre crop (at 96 px a 6x6 block, 7 px apart, from
    13 px in; scaled with px)."""
    x = np.random.default_rng(1000 + c).integers(
        0, 96, (n, px, px, 3), dtype=np.uint8)
    k = px / CLI_PX
    r, col = round((13 + 7 * (c // 10)) * k), round((13 + 7 * (c % 10)) * k)
    size = round(6 * k)
    x[:, r:r + size, col:col + size] += 150
    return x


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of img [H, W, 3] (zlib and struct only), its data
    stored uncompressed (zlib level 0: noise does not compress)."""
    h, w, _ = img.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # filter byte 0 on every row
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 0))
            + chunk(b"IEND", b""))


def write_cli_dataset(root: str, splits=CLI_SPLITS,
                      n_images: int = CLI_IMAGES, crop: int = CLI_CROP,
                      canvas_base: bool = True) -> dict:
    """The miniImagenet layout under root/filelists/miniImagenet: PNGs of
    int(1.15 * crop) px and base/val/novel.json, then each split's stage
    cache as the CLIs stage it (with canvas_base the canvas for base, as
    --train_aug stages it; else, and for val and novel, the eval crop),
    keyed by the port's own _stage_cache_key: the image is its own canvas,
    and the eval transform of it (Scale to its own size, CenterCrop crop)
    is its centre crop. Returns split -> the filelist's path."""
    from deep_kernel_transfer_tpu_torch.data.device_dataset import (
        _stage_cache_key, _stage_cache_store)

    px = int(crop * 1.15)
    d = os.path.join(root, "filelists", "miniImagenet")
    os.makedirs(os.path.join(d, "images"))
    files, first = {}, 0
    lo = (px - crop) // 2
    def write_class(split: str, c: int) -> tuple[np.ndarray, list[str]]:
        imgs = class_images(c, n_images, px)
        paths = [os.path.join(d, "images", f"{split}_{c}_{i}.png")
                 for i in range(n_images)]
        for img, path in zip(imgs, paths):
            with open(path, "wb") as f:
                f.write(png_bytes(img))
        return imgs, paths

    with ThreadPoolExecutor(8) as pool:
        for split, n_class in splits:
            done = list(pool.map(lambda c: write_class(split, c),
                                 range(first, first + n_class)))
            imgs = np.concatenate([i for i, _ in done])
            paths = [p for _, ps in done for p in ps]
            files[split] = os.path.join(d, f"{split}.json")
            with open(files[split], "w") as f:
                json.dump({"label_names": [f"c{first + c}"
                                           for c in range(n_class)],
                           "image_names": paths,
                           "image_labels": [first + c for c in range(n_class)
                                            for _ in range(n_images)]}, f)
            canvas = canvas_base and split == "base"
            host = imgs if canvas else imgs[:, lo:lo + crop, lo:lo + crop]
            _stage_cache_store(files[split], _stage_cache_key(
                paths, crop, canvas), crop, canvas, host)
            first += n_class
    return files


def drive_cli_path(device, card: str, step_ms: float) -> dict:
    """The CLIs' main path at full width in a temporary working directory
    (see the module docstring). Returns the kernel's launch count over the
    train and test runs."""
    from deep_kernel_transfer_tpu_torch import test, train
    from deep_kernel_transfer_tpu_torch.data import device_dataset as dd
    from deep_kernel_transfer_tpu_torch.data.device_aug import augment
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
    from deep_kernel_transfer_tpu_torch.utils.checkpoint import (
        get_resume_file)

    import importlib.util

    print(f"PIL importable: {importlib.util.find_spec('PIL') is not None}",
          flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            files = write_cli_dataset(root)
            print(f"CLI dataset: {len(CLI_SPLITS)} splits, "
                  f"{sum(n for _, n in CLI_SPLITS) * CLI_IMAGES} PNGs and "
                  f"stage caches written in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            check_native_staging(files, device, card)
            torch.cuda.reset_peak_memory_stats()
            for split, canvas in (("base", True), ("val", False),
                                  ("novel", False)):
                t0 = time.perf_counter()
                ds = dd.cached_dataset(files[split], CLI_CROP, canvas=canvas,
                                       device=device, verbose=True)
                torch.cuda.synchronize()
                print(f"staged {split}: {tuple(ds.images.shape)} uint8, "
                      f"{ds.images.numel() / 2**30:.3f} GiB on the device in "
                      f"{time.perf_counter() - t0:.2f} s, from the stage "
                      f"cache: {ds.from_cache} [{card}]", flush=True)
            staged = list(dd._CACHE.values())
            if len(staged) != 3 or not all(ds.from_cache for ds in staged):
                raise AssertionError("a split was not staged from its cache")

            # each epoch ends with its <epoch>.tar: time the epochs there
            ends, save = [], train.save_checkpoint

            def timed_save(path, model, epoch=-1):
                if not path.endswith("best_model.tar"):
                    torch.cuda.synchronize()
                    ends.append(time.perf_counter())
                save(path, model, epoch)

            train.save_checkpoint = timed_save
            fused_linear_mll.launches = 0
            t0 = time.perf_counter()
            try:
                model = train.main(CLI_ARGS + ["--n_train_episodes=320",
                                               "--stop_epoch=2"])
            finally:
                train.save_checkpoint = save
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            epoch_s = [b - a for a, b in zip([t0] + ends, ends)]
            t0 = time.perf_counter()
            acc, ci = test.main(CLI_ARGS + ["--n_iter=600", "--repeat=1"])
            eval_s = time.perf_counter() - t0
            launches = {"fused_linear_mll": fused_linear_mll.launches}
            print(f"CLI path: train 2 epochs of 10 batches in {train_s:.2f} s "
                  f"(epochs with their validation and saves: "
                  f"{', '.join(f'{v:.2f}' for v in epoch_s)} s, the first "
                  f"with the model's set-up), 600-episode test in "
                  f"{eval_s:.2f} s, accuracy "
                  f"{acc:.2f}% +- {ci:.2f}%, fused_linear_mll launches "
                  f"{launches} [{card}]", flush=True)
            if launches["fused_linear_mll"] != 20:
                raise AssertionError(f"want 20 launches (2 epochs x 10 "
                                     f"batches): {launches}")
            check_cli_outputs(get_resume_file, acc)
            print(f"CLI path peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"[{card}]", flush=True)

            base = dd._CACHE[next(k for k in dd._CACHE if k[3])]
            gen = base.generator(0)
            sample_ms = cuda_ms(lambda: augment(gen, base.sample_episodes(
                gen, MAIN_WAY, MAIN_SHOT, 16, MAIN_B), MAIN_PX), iters=10)
            chunk = dd.make_fused_epoch(model, base, MAIN_WAY, MAIN_SHOT, 16,
                                        MAIN_B, augment_to=MAIN_PX)
            batch_ms = cuda_ms(lambda: chunk(gen, 1), iters=10)
            print(f"CLI loop, B={MAIN_B} 5w5s16q at 84 px from 96-px "
                  f"canvases: sample+augment {sample_ms:.3f} ms a batch, "
                  f"sample+augment+train step {batch_ms:.3f} ms a batch "
                  f"against the bare train_step's {step_ms:.3f} ms (phase 5) "
                  f"[{card}]", flush=True)
        finally:
            os.chdir(cwd)
            dd._CACHE.clear()
    return launches


# -- the native decoder -------------------------------------------------------

def _header_found(header: str) -> bool:
    """Whether g++ finds `header` (it preprocesses a file including it)."""
    try:
        return subprocess.run(
            ["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
            input=f"#include <stdio.h>\n#include <{header}>\n", text=True,
            capture_output=True, timeout=60).returncode == 0
    except OSError:
        return False


def check_native_staging(files: dict, device, card: str) -> None:
    """The native decoder on this machine: whether g++, jpeglib.h and png.h
    are there and whether the library built. Then the CLI phase's val
    split (16 classes x 600 stdlib-written 96-px PNGs) staged cold, eval
    (84 px) and canvas (96 px), by the decoder the CLIs take here (the
    native one where it built, else PIL), with images a second: the host
    decode cost of staging, and of each host-loader batch. At 96 px both
    transforms resample at the PNG's own size, the identity, so the staged
    pixels must be the written ones exactly (the eval one's centre crop);
    where both decoders run, PIL's staging of a sample must equal them."""
    import importlib.util

    from deep_kernel_transfer_tpu_torch import native
    from deep_kernel_transfer_tpu_torch.data import device_dataset as dd
    from deep_kernel_transfer_tpu_torch.data.transforms import (
        TransformPipeline, load_canvas)

    found = {"g++": shutil.which("g++") is not None,
             "jpeglib.h": _header_found("jpeglib.h"),
             "png.h": _header_found("png.h")}
    built = native.available()
    has_pil = importlib.util.find_spec("PIL") is not None
    print(f"native decoder: found {found}; library built: {built}; PIL "
          f"importable: {has_pil}", flush=True)
    if not built:
        print("native decoder: it did not build on this machine, so the "
              "CLIs decode with PIL here", flush=True)
        if not has_pil:
            return
    first = dict(CLI_SPLITS)["base"]
    written = np.concatenate([class_images(c, CLI_IMAGES)
                              for c in range(first,
                                             first + dict(CLI_SPLITS)["val"])])
    lo = (CLI_PX - CLI_CROP) // 2
    with open(files["val"]) as f:
        sample = json.load(f)["image_names"][::150]
    old = os.environ.get("DKT_NO_STAGE_CACHE")
    os.environ["DKT_NO_STAGE_CACHE"] = "1"  # decode, and leave the caches
    try:
        for canvas in (False, True):
            t0 = time.perf_counter()
            ds = dd.DeviceDataset(files["val"], CLI_CROP, canvas=canvas,
                                  device=device, verbose=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = ds.images.cpu().numpy()
            want = written if canvas else written[:, lo:lo + CLI_CROP,
                                                  lo:lo + CLI_CROP]
            label = "canvas 96 px" if canvas else "eval 84 px"
            print(f"staging decode: val split ({got.shape[0]} PNGs) staged "
                  f"cold, {label}, by {ds.decoder} in {secs:.2f} s, "
                  f"{got.shape[0] / secs:.0f} images/s (decode, transform, "
                  f"copy to the card) [{card}]", flush=True)
            if ds.decoder != ("native decoder" if built else "PIL"):
                raise AssertionError(f"staged by {ds.decoder}")
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{label}: staged pixels differ from "
                                     f"the written ones")
            if built and has_pil:
                pil = (np.stack([load_canvas(p, CLI_PX) for p in sample])
                       if canvas else TransformPipeline(
                           CLI_CROP, aug=False, use_native=False).load_batch(
                               sample))
                if not np.array_equal(pil, got[::150]):
                    raise AssertionError(f"{label}: PIL differs on the "
                                         f"sample")
            del ds
        print("staging decode: the staged pixels equal the written ones"
              + (f", and PIL's on {len(sample)} of them"
                 if built and has_pil else ""), flush=True)
    finally:
        if old is None:
            del os.environ["DKT_NO_STAGE_CACHE"]
        else:
            os.environ["DKT_NO_STAGE_CACHE"] = old


def check_cli_outputs(get_resume_file, acc: float) -> None:
    """The CLI run's files: finite losses and the telemetry in
    log/metrics.jsonl, reference-layout checkpoints, the results line."""
    ckpt = "save/checkpoints/miniImagenet/Conv4_DKT_aug_5way_5shot"
    with open(f"{ckpt}/log/metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    losses = [r[k] for r in records for k in ("loss", "epoch_loss") if k in r]
    keys = set().union(*records)
    print(f"CLI metrics: losses {losses}, GP accuracies "
          f"{[(r['GP_support_accuracy'], r['GP_query_accuracy']) for r in records if 'GP_query_accuracy' in r]}"
          , flush=True)
    if len(losses) != 4 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"want 4 finite losses, got {losses}")
    want = {"GP_support_accuracy", "GP_query_accuracy", "z_support/mean"}
    if not want <= keys:
        raise AssertionError(f"metrics.jsonl lacks {want - keys}")
    names = sorted(os.listdir(ckpt))
    if names != ["0.tar", "1.tar", "best_model.tar", "log"]:
        raise AssertionError(f"checkpoints {names}")
    if get_resume_file(ckpt) != f"{ckpt}/1.tar":
        raise AssertionError("the latest checkpoint is not 1.tar")
    for name in ("0.tar", "1.tar", "best_model.tar"):
        state = torch.load(f"{ckpt}/{name}", weights_only=True)["state"]
        for w in range(MAIN_WAY):
            if f"model.models.{w}.covar_module.raw_outputscale" not in state:
                raise AssertionError(f"{name} lacks way {w}'s GP")
        if any(k.startswith("gp.") for k in state) or not all(
                bool(torch.isfinite(v).all()) for v in state.values()):
            raise AssertionError(f"{name} is not a finite reference layout")
    with open("record/results.txt") as f:
        line = f.read().splitlines()[-1]
    print(f"record/results.txt: {line}", flush=True)
    if "miniImagenet-Conv4-DKT-aug 5shot 5way_test" not in line:
        raise AssertionError("no results line")
    if not acc > 50.0:
        raise AssertionError(f"test accuracy {acc:.2f}% is not above 50%")


# -- the test-time heads on real digits ---------------------------------------

HEADS_ARGS = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
              "--train_n_way=5", "--test_n_way=5", "--n_shot=5", "--seed=1"]
HEADS_EPISODES, HEADS_BATCH, ADAPT_STEPS = 600, 32, 100


def drive_heads_path(device, card: str) -> dict:
    """DKT's test-time heads through the CLIs on the committed digits
    (deep_kernel_transfer_tpu_torch/benchmarks/digits.npz), in a temporary
    working directory: the digits_real filelists (28-px JPEGs), 2 epochs of
    `train.main`, then `test.main` plain, --laplace and --adaptation (600
    episodes, 32 a batch, one repeat each) and `test_uncertainty.main` at
    --n_iter 100 and --repeat 1. Checks that the adaptation run launched
    the fused MLL 100 times for each episode batch, that every accuracy
    beats 35% (chance is 20%) and that the ECEs are finite and in [0, 1].
    Returns the fused MLL's launches over the phase."""
    from deep_kernel_transfer_tpu_torch import test, test_uncertainty, train
    from deep_kernel_transfer_tpu_torch.benchmarks.digits_real import (
        make_digits_filelists)
    from deep_kernel_transfer_tpu_torch.data import device_dataset as dd
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    test_args = HEADS_ARGS + [f"--n_iter={HEADS_EPISODES}", "--repeat=1",
                              f"--episode_batch={HEADS_BATCH}"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        try:
            t0 = time.perf_counter()
            make_digits_filelists(root)
            os.chdir(root)
            print(f"heads phase: digits filelists written in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            fused_linear_mll.launches = 0
            t0 = time.perf_counter()
            train.main(HEADS_ARGS + ["--stop_epoch=2"])
            torch.cuda.synchronize()
            wall = {"train 2 epochs": time.perf_counter() - t0}
            accs = {}
            for head, flags in (("plain", []), ("laplace", ["--laplace"]),
                                ("adaptation", ["--adaptation"])):
                before = fused_linear_mll.launches
                t0 = time.perf_counter()
                accs[head] = test.main(test_args + flags)[0]
                wall[head] = time.perf_counter() - t0
                launched = fused_linear_mll.launches - before
                print(f"heads phase: test {head}: accuracy {accs[head]:.2f}% "
                      f"in {wall[head]:.2f} s, fused_linear_mll launches "
                      f"{launched} [{card}]", flush=True)
                if head == "adaptation":
                    want = ADAPT_STEPS * -(-HEADS_EPISODES // HEADS_BATCH)
                    if launched != want:
                        raise AssertionError(
                            f"adaptation launched the fused MLL {launched} "
                            f"times, want {want} (100 a batch)")
            t0 = time.perf_counter()
            cal = test_uncertainty.main(HEADS_ARGS + [
                "--n_iter=100", "--repeat=1", f"--episode_batch={HEADS_BATCH}"])
            wall["test_uncertainty"] = time.perf_counter() - t0
            total = fused_linear_mll.launches
        finally:
            os.chdir(cwd)
            dd._CACHE.clear()
    print(f"heads phase: wall s {wall}, calibration {cal}, fused_linear_mll "
          f"launches {total} [{card}]", flush=True)
    if not all(a > 35.0 for a in accs.values()):
        raise AssertionError(f"a head is not above 35%: {accs}")
    for k in ("ece_raw", "ece_cal"):
        if not (math.isfinite(cal[k]) and 0.0 <= cal[k] <= 1.0):
            raise AssertionError(f"{k} = {cal[k]} is not in [0, 1]")
    return {"fused_linear_mll": total}


WOODBURY_N, WOODBURY_D, WOODBURY_M = 4096, 256, 1024


def drive_woodbury_path(device, card: str) -> None:
    """The exact GP's Woodbury route against its dense route on the card:
    ExactGP.mll and .posterior with the bncossim kernel at N=4096, D=256
    (1024 queries), routed (2D <= N) and with force_dense=True. Holds the
    mll to 1e-4 relative and the posterior mean to 1e-4 absolute, and
    prints each route's ms and peak device memory."""
    from deep_kernel_transfer_tpu_torch.gp import ExactGP, GaussianLikelihood
    from deep_kernel_transfer_tpu_torch.gp.kernels import make_kernel

    n, d, m = WOODBURY_N, WOODBURY_D, WOODBURY_M
    x = unit_rows(1, n + m, d, device, seed=7)[0]
    x_train, x_query = x[:n], x[n:]
    y = torch.from_numpy(np.where(np.random.RandomState(7).rand(n) < 0.2,
                                  1.0, -1.0).astype(np.float32)).to(device)
    routes = {}
    for name, dense in (("woodbury", False), ("dense", True)):
        spec = ExactGP(make_kernel("bncossim"),
                       GaussianLikelihood(trainable=False, fixed_noise=NOISE),
                       assume_pd=True, force_dense=dense)
        params = spec.init(device=device)
        if spec._use_low_rank(params, x_train) == dense:
            raise AssertionError(f"{name} route not taken")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mll = spec.mll(params, x_train, y)
        post = spec.posterior(params, x_train, y, x_query)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms = ms_in_turns({
            "mll": lambda: spec.mll(params, x_train, y),
            "posterior": lambda: spec.posterior(params, x_train, y, x_query)},
            rounds=3, iters=5, warmup=2)
        routes[name] = (mll, post.mean, ms, peak)
        print(f"Woodbury phase, {name} route at N={n} D={d} M={m}: mll "
              f"{float(mll)!r}, mll {ms['mll'][0]:.3f} ms, posterior "
              f"{ms['posterior'][0]:.3f} ms (medians of 3 turns), peak "
              f"{peak:.4f} GiB above the inputs [{card}]", flush=True)
    (mll_w, mean_w, _, _), (mll_d, mean_d, _, _) = (routes["woodbury"],
                                                    routes["dense"])
    check(f"Woodbury vs dense route N={n} D={d}",
          {"mll rel": float((mll_w - mll_d).abs() / mll_d.abs()),
           "posterior mean abs": float((mean_w - mean_d).abs().max())},
          {"mll rel": 1e-4, "posterior mean abs": 1e-4})


# the Woodbury CLI part: the workload at full width, depth cut to 2 epochs
WOODBURY_CLI_EPOCHS = 2
WOODBURY_CLI_ARMS_LIMIT = 0.2  # points between the two arms' accuracies
# percent; chance is 5% at 20 ways. Set 21 points below the 81.13% that
# the first run of this part reached on an H100 80GB HBM3 at 700 W
WOODBURY_CLI_FLOOR = 60.0


def drive_woodbury_cli_path(device, card: str) -> None:
    """The Woodbury CLI workload (deep_kernel_transfer_tpu_torch/
    benchmarks/woodbury_workload.py) at full width: 250 glyph classes of
    28-px JPEGs, DKT on Conv4S with the bncossim kernel, 20-way 15-shot,
    8 episodes a batch; depth cut to WOODBURY_CLI_EPOCHS epochs. The step
    A/B (episodes/s of the train step and the eval, Woodbury route against
    force_dense), `train`, then `test` (600 episodes, one run) on both
    arms, every kernel's launches counted from 0. The runner fails unless
    ExactGP routes N = 620 (train) and N = 300 (eval) to Woodbury in the
    routed arm and to the dense Gram in the force_dense arm; this part
    fails unless no kernel of the port launched (the route is cuBLAS and
    cuSOLVER products), the two arms' accuracies lie within
    WOODBURY_CLI_ARMS_LIMIT points and both above WOODBURY_CLI_FLOOR."""
    from deep_kernel_transfer_tpu_torch.benchmarks import woodbury_workload

    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        rows = woodbury_workload.main(
            [f"--epochs={WOODBURY_CLI_EPOCHS}", "--repeat=1",
             f"--root={root}", f"--report={os.path.join(root, 'r.json')}"],
            device=device)
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    acc = {arm: rows[f"{key}_acc"]
           for arm, key in woodbury_workload.ARMS.items()}
    print(f"Woodbury CLI part, 20-way 15-shot, B = 8, 28 px: step A/B "
          f"train {rows['glyphs20w_woodbury_train_eps_per_sec']:.2f} "
          f"episodes/s on the Woodbury route against "
          f"{rows['glyphs20w_dense_train_eps_per_sec']:.2f} dense, eval "
          f"{rows['glyphs20w_woodbury_eval_eps_per_sec']:.2f} against "
          f"{rows['glyphs20w_dense_eval_eps_per_sec']:.2f} (CUDA events, 10 "
          f"calls after 2 warm-up); routes: step A/B "
          f"{rows['glyphs20w_woodbury_routes']} and "
          f"{rows['glyphs20w_dense_routes']}, train "
          f"{rows['glyphs20w_train_routes']}, test "
          f"{rows['glyphs20w_dkt_20way_15shot_routes']} and "
          f"{rows['glyphs20w_dense_20way_15shot_routes']}; train "
          f"{rows['glyphs20w_dkt_train_s']:.1f} s ({WOODBURY_CLI_EPOCHS} "
          f"epochs), test {rows['glyphs20w_dkt_20way_15shot_test_s']:.1f} s "
          f"(Woodbury) and {rows['glyphs20w_dense_20way_15shot_test_s']:.1f}"
          f" s (dense); accuracy {acc['woodbury']:.2f}% (Woodbury) and "
          f"{acc['dense']:.2f}% (dense), floor {WOODBURY_CLI_FLOOR}%; "
          f"launches {launches}; {wall:.1f} s in all [{card}]", flush=True)
    if any(launches.values()):
        raise AssertionError(f"the Woodbury CLI part launched {launches}")
    if abs(acc["woodbury"] - acc["dense"]) > WOODBURY_CLI_ARMS_LIMIT:
        raise AssertionError("the Woodbury and dense arms' accuracies part")
    if min(acc.values()) <= WOODBURY_CLI_FLOOR:
        raise AssertionError("the Woodbury CLI run's accuracy is below its "
                             "floor")


# -- DKT on ResNet10 at 224 px ------------------------------------------------

RES_B, RES_PX, RES_QUERY = 8, 224, 16  # N = 5 * (5 + 16) = 105
RES_D = 512
RES_CLI_SPLITS = (("base", 10), ("val", 5), ("novel", 5))
RES_CLI_IMAGES = 25


def check_fused_mll_resnet(device, d: int = RES_D,
                           label: str = "ResNet10") -> None:
    """The fused MLL at a ResNet path's shape, B=8 N=105 W=5 and D = 512
    (ResNet10) or 2048 (ResNet50): kernel against plain version with
    check_fused_mll's limits, and kernel, plain version and library call
    timed in turns, with the bound."""
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import (
        fused_linear_mll, fused_linear_mll_plain)

    n = MAIN_WAY * (MAIN_SHOT + RES_QUERY)
    check(f"fused_mll B={RES_B} N={n} D={d} W={MAIN_WAY}",
          fused_mll_errors(RES_B, n, d, MAIN_WAY, device),
          FUSED_MLL_LIMITS)
    z, diffs, scales = mll_inputs(RES_B, n, d, MAIN_WAY, device)
    times = ms_in_turns({
        "kernel": lambda: fused_linear_mll(z, diffs, scales, n, NOISE),
        "plain": lambda: fused_linear_mll_plain(z, diffs, scales, n, NOISE),
        "library": lambda: library_mll(z, diffs, scales, NOISE)})
    bound = fused_mll_bound_ms(RES_B, n, d, MAIN_WAY)
    print(f"fused_linear_mll {label} shape B={RES_B} N={n} D={d} "
          f"W={MAIN_WAY}, median (min-max) of turns: " + ", ".join(
              f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) ms"
              for k, v in times.items())
          + f", bound {bound[0]:.6f} ms ({bound[1]})", flush=True)


def resnet_train_steps(device, card: str, trunk, steps: int, layers: int,
                       seed: int, profile: bool = False) -> dict:
    """DKT(trunk, bncossim) at full width: 224-px 5w5s16q episodes (N =
    105), 8 a step, bf16 trunk, random uint8 pixels from a CUDA generator
    seeded with `seed`. `steps` train steps through the fused MLL with the
    launches counted (one fused MLL a step; every one of the trunk's
    `layers` BatchNorms on the kernels once each way, no layout copy), the
    first batch's loss against the plain GP route; the step timed by CUDA
    events in turns, episodes/s, peak memory and, with `profile`, a
    torch.profiler table. Returns the launches."""
    from deep_kernel_transfer_tpu_torch.methods import DKT
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    name = trunk.__name__
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (RES_B, MAIN_WAY, MAIN_SHOT + RES_QUERY, RES_PX, RES_PX, 3)
    batches = [torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8) for _ in range(2)]

    def build(fused: bool):
        return DKT(trunk(), MAIN_WAY, MAIN_SHOT, kernel_type="bncossim",
                   feature_dtype="bfloat16", use_fused_mll=fused,
                   device=device).init(batches[0][0],
                                       torch.Generator().manual_seed(0))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(True)
    plain = build(False)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        plain_loss = plain.batch_loss_train(batches[0])[0].item()
    del plain
    fused_linear_mll.launches = 0
    reset_batchnorm_counts()
    losses = [model.train_step(batches[i % 2])["loss"] for i in range(steps)]
    torch.cuda.synchronize()
    launched = fused_linear_mll.launches
    bn_launched = check_batchnorm_route(f"{name} path", steps, layers)
    losses = [float(v) for v in losses]
    print(f"{name} path: {steps} train steps (bncossim, {MAIN_WAY}w"
          f"{MAIN_SHOT}s{RES_QUERY}q, {RES_PX} px, B={RES_B}, bf16 trunk), "
          f"losses {losses}, fused_linear_mll launches {launched}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite {name} loss: {losses}")
    if launched != steps:
        raise AssertionError(f"want {steps} fused-MLL launches, got {launched}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print(f"{name} step 1 loss: fused route {losses[0]!r}, plain route "
          f"{plain_loss!r}, relative difference {rel:.3e}", flush=True)
    if rel >= 1e-4:
        raise AssertionError(f"{name}: fused route disagrees with plain")
    times = ms_in_turns({"step": lambda: model.train_step(batches[0])},
                        rounds=4, iters=3, warmup=1)
    ms, lo, hi = times["step"]
    print(f"{name} train step: {ms:.3f} ms (median of 4 turns, "
          f"{lo:.3f}-{hi:.3f}), {RES_B / ms * 1e3:.1f} episodes/s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)
    if profile:
        profile_step(lambda: model.train_step(batches[0]))
    del model, batches
    torch.cuda.empty_cache()
    return {"fused_linear_mll": launched, "episodic_batchnorm": bn_launched}


def drive_resnet_path(device, card: str) -> dict:
    """DKT(ResNet10, bncossim) at full width (D = 512): the fused MLL at
    that shape against its plain version, then 5 train steps as
    resnet_train_steps drives them, with a torch.profiler table. Then
    `train` (one epoch of 3 batches of 8) and `test` through the CLI on a
    generated 224-px miniImagenet-layout set. Returns the launches over
    the phase."""
    from deep_kernel_transfer_tpu_torch import test, train
    from deep_kernel_transfer_tpu_torch.data import device_dataset as dd
    from deep_kernel_transfer_tpu_torch.models import ResNet10
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    check_fused_mll_resnet(device)
    launches = resnet_train_steps(device, card, ResNet10, 5, 12, seed=1,
                                  profile=True)

    cwd = os.getcwd()
    args = ["--dataset=miniImagenet", "--model=ResNet10", "--method=DKT",
            f"--episode_batch={RES_B}"]
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            write_cli_dataset(root, RES_CLI_SPLITS, RES_CLI_IMAGES, RES_PX,
                              canvas_base=False)
            write_s = time.perf_counter() - t0
            before = fused_linear_mll.launches
            t0 = time.perf_counter()
            train.main(args + ["--n_train_episodes=24", "--stop_epoch=1"])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            cli_launches = fused_linear_mll.launches - before
            t0 = time.perf_counter()
            acc, ci = test.main(args + ["--n_iter=48", "--repeat=1"])
            test_s = time.perf_counter() - t0
            ckpt = "save/checkpoints/miniImagenet/ResNet10_DKT_5way_5shot"
            names = sorted(os.listdir(ckpt))
        finally:
            os.chdir(cwd)
            dd._CACHE.clear()
    print(f"ResNet10 CLI: dataset written in {write_s:.1f} s; train 1 epoch "
          f"of 3 batches in {train_s:.2f} s (fused_linear_mll launches "
          f"{cli_launches}), 48-episode test in {test_s:.2f} s, accuracy "
          f"{acc:.2f}% +- {ci:.2f}%, checkpoints {names} [{card}]",
          flush=True)
    if cli_launches != 3 or names != ["0.tar", "best_model.tar", "log"]:
        raise AssertionError("the ResNet10 CLI run did not train 3 batches")
    if not 0.0 <= acc <= 100.0:
        raise AssertionError(f"ResNet10 CLI accuracy {acc}")
    launches["fused_linear_mll"] += cli_launches
    return launches


def drive_resnet50_path(device, card: str) -> dict:
    """DKT(ResNet50, bncossim) at full width, the benchmark cell
    resnet50_cub_train_b8's shapes (D = 2048): the fused MLL at that shape
    against its plain version, then 3 train steps as resnet_train_steps
    drives them, all 49 BatchNorms on the kernels. Returns the
    launches."""
    from deep_kernel_transfer_tpu_torch.models import ResNet50

    check_fused_mll_resnet(device, 2048, "ResNet50")
    return resnet_train_steps(device, card, ResNet50, 3, 49, seed=2)


SWIN_SHAPE = (840, 56, 96, 3, 7, 3)  # images, map side, C, heads, window, shift


def swin_attention_shapes() -> list:
    """The distinct (map side, C, heads, window, shift) of SwinT's 12
    window attentions, in the trunk's order: stages 1-3 unshifted and
    shifted, stage 4's 7 x 7 map one unshifted window."""
    from deep_kernel_transfer_tpu_torch.models import SwinT
    from deep_kernel_transfer_tpu_torch.models.backbones import \
        WindowAttention

    shapes = []
    for m in SwinT().modules():
        if isinstance(m, WindowAttention):
            key = (m.resolution, m.qkv.in_features, m.heads, m.window,
                   m.shift)
            if key not in shapes:
                shapes.append(key)
    return shapes


def window_attention_bound_ms(n: int, side: int, c: int,
                              window: int) -> tuple[float, str]:
    """The least time of one block's attention forward and backward: the
    larger of 22 bytes an element of [n, side^2, c] at 3.35 TB/s and seven
    products of side^2 x window^2 x c multiply-adds an image at 989
    TFLOP/s (dkt_bench/metrics/window_attention_roofline.train.py)."""
    elements = n * side * side * c
    t_bytes = 22.0 * elements / PEAK_BYTES * 1e3
    t_ops = 14.0 * elements * window * window / 989e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "bf16 mma")


def check_window_attention(device) -> dict:
    """The shifted-window attention kernels (ops/window_attention.py) at
    every distinct shape of SwinT's blocks in the benchmark cell's step
    (840 images; `swin_attention_shapes`): o, dqkv and the bias table's
    gradient against the torch chain in bf16, two calls' o bit-equal, one
    launch each way and none to the chain. Then, at one stage-1 block's
    shapes (56 x 56 tokens, C = 96, 3 heads of 32, 7x7 windows shifted by
    3), forward + backward timed in turns beside the chain, with the
    22-bytes-an-element bound. Returns the kernel's JSON entry (no library
    call computes it: SDPA takes no shifted windows and would pad the
    49-wide bias)."""
    from deep_kernel_transfer_tpu_torch.ops import window_attention as wa

    n = SWIN_SHAPE[0]
    shapes = swin_attention_shapes()
    if len(shapes) != 7 or tuple(SWIN_SHAPE[1:]) not in shapes:
        raise AssertionError(f"SwinT's attention shapes: {shapes}")

    def inputs(side, c, heads, window):
        gen = torch.Generator(device=device).manual_seed(side)
        qkv = torch.randn((n, side * side, 3 * c), generator=gen,
                          device=device).to(torch.bfloat16)
        table = 0.5 * torch.randn(((2 * window - 1) ** 2, heads),
                                  generator=gen, device=device)
        do = torch.randn((n, side * side, c), generator=gen,
                         device=device).to(torch.bfloat16)
        return qkv, table, do

    def fwd_bwd(fn, qkv, table, do, heads, window, shift, side):
        q = qkv.detach().requires_grad_(True)
        t = table.detach().requires_grad_(True)
        o = fn(q, t, heads, window, shift, (side, side))
        return (o,) + torch.autograd.grad(o, (q, t), do)

    worst = 0.0
    for side, c, heads, window, shift in shapes:
        args = inputs(side, c, heads, window) + (heads, window, shift, side)
        before = (wa.window_attention.launches,
                  wa.window_attention.torch_route)
        got = fwd_bwd(wa.window_attention, *args)
        torch.cuda.synchronize()
        launched = (wa.window_attention.launches - before[0],
                    wa.window_attention.torch_route - before[1])
        want = fwd_bwd(wa.window_attention_torch, *args)
        errs = {name: float((a.float() - b.float()).abs().max()
                            / b.float().abs().max())
                for name, a, b in zip(("o", "dqkv", "dtable"), got, want)}
        with torch.no_grad():
            again = wa.window_attention(args[0], args[1], heads, window,
                                        shift, (side, side))
        errs["repeat"] = float((again.float() - got[0].float()).abs().max())
        del got, want, again, args
        torch.cuda.empty_cache()
        label = f"window_attention n={n} {side}x{side} C={c} " \
                f"heads={heads} window={window} shift={shift}"
        print(f"{label}: launches (kernel, chain) {launched}", flush=True)
        check(label, errs, {"o": 2 ** -7, "dqkv": 2 ** -6, "dtable": 1e-2,
                            "repeat": 1e-30})
        if launched != (2, 0):
            raise AssertionError(f"{label}: want one launch each way, none "
                                 f"to the chain: {launched}")
        worst = max(worst, errs["o"])
    n, side, c, heads, window, shift = SWIN_SHAPE
    args = inputs(side, c, heads, window) + (heads, window, shift, side)
    torch.cuda.reset_peak_memory_stats()
    times = ms_in_turns(
        {"kernel": lambda: fwd_bwd(wa.window_attention, *args),
         "plain": lambda: fwd_bwd(wa.window_attention_torch, *args)},
        rounds=4, iters=5, warmup=1)
    bound = window_attention_bound_ms(n, side, c, window)
    print(f"window_attention forward+backward n={n} {side}x{side} C={c} "
          f"heads={heads} window={window} shift={shift}, median (min-max) "
          "of turns: " + ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) "
                                   "ms" for k, v in times.items())
          + f", bound {bound[0]:.4f} ms ({bound[1]}), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del args
    torch.cuda.empty_cache()
    return {"name": "window_attention", "route": "cuda",
            "source": "deep_kernel_transfer_tpu_torch/csrc/window_attention.cu",
            "replaces": "none (the port's own trunk)", "launches": None,
            "max_abs_err": worst, "ms": times["kernel"][0],
            "plain_ms": times["plain"][0], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None}


def drive_swint_path(device, card: str, steps: int = 3) -> dict:
    """DKT(SwinT, bncossim) at full width, the benchmark cell
    swint_cub_train_b8's shapes (D = 768, 840 images at 224 px a step):
    the fused MLL at that shape against its plain version, then `steps`
    train steps with the launches counted: one fused MLL a step, and every
    block's attention on the kernels, one forward and one backward launch
    a block a step (12 blocks), none to the chain; the first batch's loss
    against the plain GP route; and one step's peak memory with every
    attention on the kernels and on the torch chain (the cell times the
    step). Returns the launches."""
    from deep_kernel_transfer_tpu_torch.methods import DKT
    from deep_kernel_transfer_tpu_torch.models import SwinT
    from deep_kernel_transfer_tpu_torch.ops import window_attention as wa
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    window_attention, supports = wa.window_attention, wa.supports
    check_fused_mll_resnet(device, 768, "SwinT")
    gen = torch.Generator(device=device).manual_seed(3)
    shape = (RES_B, MAIN_WAY, MAIN_SHOT + RES_QUERY, RES_PX, RES_PX, 3)
    batches = [torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8) for _ in range(2)]

    def build(fused: bool):
        return DKT(SwinT(), MAIN_WAY, MAIN_SHOT, kernel_type="bncossim",
                   feature_dtype="bfloat16", use_fused_mll=fused,
                   device=device).init(batches[0][0],
                                       torch.Generator().manual_seed(0))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(True)
    plain = build(False)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        plain_loss = plain.batch_loss_train(batches[0])[0].item()
    del plain
    fused_linear_mll.launches = 0
    window_attention.launches = window_attention.torch_route = 0
    reset_batchnorm_counts()
    losses = [model.train_step(batches[i % 2])["loss"] for i in range(steps)]
    torch.cuda.synchronize()
    launched = {"fused_linear_mll": fused_linear_mll.launches,
                "window_attention": window_attention.launches}
    check_batchnorm_route("SwinT path", steps, 0)
    losses = [float(v) for v in losses]
    print(f"SwinT path: {steps} train steps (bncossim, {MAIN_WAY}w"
          f"{MAIN_SHOT}s{RES_QUERY}q, {RES_PX} px, B={RES_B}, bf16 trunk), "
          f"losses {losses}, launches {launched}, window_attention torch "
          f"route {window_attention.torch_route}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite SwinT loss: {losses}")
    if launched != {"fused_linear_mll": steps,
                    "window_attention": 2 * 12 * steps} or \
            window_attention.torch_route:
        raise AssertionError(f"SwinT launches {launched}, torch route "
                             f"{window_attention.torch_route}")
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print(f"SwinT step 1 loss: fused route {losses[0]!r}, plain route "
          f"{plain_loss!r}, relative difference {rel:.3e}", flush=True)
    if rel >= 1e-4:
        raise AssertionError("SwinT: fused route disagrees with plain")
    # one step's peak on each route: the chain keeps the [windows, heads,
    # 49, 49] scores (stage 1's are 0.77 GB in bf16 a block), the kernels none
    peaks = {}
    for route in ("kernel", "chain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if route == "chain":
            wa.supports = lambda *a: False
        try:
            model.train_step(batches[0])
            torch.cuda.synchronize()
        finally:
            wa.supports = supports
        peaks[route] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"SwinT train step peak: kernels {peaks['kernel']:.3f} GiB, torch "
          f"chain {peaks['chain']:.3f} GiB [{card}]", flush=True)
    del model, batches
    torch.cuda.empty_cache()
    return launched


# -- the comparison methods through the CLIs ----------------------------------

ZOO_METHODS = ("protonet", "matchingnet", "relationnet", "relationnet_softmax",
               "maml", "maml_approx", "baseline", "baseline++")
ZOO_IMAGES = 30  # a class, in each split of the CLI phase's layout
ZOO_ARGS = ["--dataset=miniImagenet", "--model=Conv4", "--episode_batch=8"]
# the episodic methods 2 epochs of 10 batches of 8 episodes (RelationNet
# validates at 81% after one, 100% after two); MAML 4 epochs (1 x n_task)
# of 10 batches of n_task = 4; the baselines 1 epoch
_EPISODIC = ["--stop_epoch=2", "--n_train_episodes=80"]
_MAML = ["--stop_epoch=1", "--n_train_episodes=40"]
ZOO_TRAIN = {"protonet": _EPISODIC, "matchingnet": _EPISODIC,
             "relationnet": _EPISODIC, "relationnet_softmax": _EPISODIC,
             "maml": _MAML, "maml_approx": _MAML,
             "baseline": ["--stop_epoch=1"], "baseline++": ["--stop_epoch=1"]}


def drive_zoo_path(device, card: str) -> None:
    """Every comparison method through the CLIs on the CLI phase's
    miniImagenet layout (64/16/20 classes, ZOO_IMAGES 96-px PNGs a class,
    stage caches written beforehand), Conv4 at 84 px, without
    augmentation: `train` for a few batches (ZOO_TRAIN; the baselines one
    epoch of 120 minibatches of 16), then `save_features` where the method
    tests from the cache, then the 600-episode `test`; and `test
    --adaptation` for maml (100 inner steps, 32 episodes) and relationnet
    (the relation-module finetune, 100 episodes). Checks the checkpoints, the caches, finite losses and an
    accuracy above 50% (chance is 20%); prints the seconds of each part."""
    from deep_kernel_transfer_tpu_torch import save_features, test, train
    from deep_kernel_transfer_tpu_torch.data import device_dataset as dd
    from deep_kernel_transfer_tpu_torch.data.feature_cache import cache_file
    from deep_kernel_transfer_tpu_torch.io_utils import parse_args
    from deep_kernel_transfer_tpu_torch.methods import base
    from deep_kernel_transfer_tpu_torch.methods.baseline import BaselineTrain

    losses = []

    def recording(step):
        def wrapped(self, *a):
            m = step(self, *a)
            losses.append(m["loss"])
            return m
        return wrapped

    cwd = os.getcwd()
    results = {}
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        steps = (base.EpisodicMethod.train_step, BaselineTrain.train_step)
        base.EpisodicMethod.train_step = recording(steps[0])
        BaselineTrain.train_step = recording(steps[1])
        try:
            t0 = time.perf_counter()
            write_cli_dataset(root, n_images=ZOO_IMAGES, canvas_base=False)
            print(f"zoo phase: dataset written in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for method in ZOO_METHODS:
                args = ZOO_ARGS + [f"--method={method}"]
                losses.clear()
                t0 = time.perf_counter()
                train.main(args + ZOO_TRAIN[method])
                torch.cuda.synchronize()
                wall = {"train": time.perf_counter() - t0}
                values = [float(v) for v in losses]
                if not values or not all(math.isfinite(v) for v in values):
                    raise AssertionError(f"{method}: losses {values}")
                ckpt = (f"save/checkpoints/miniImagenet/Conv4_{method}"
                        + ("" if method.startswith("baseline")
                           else "_5way_5shot"))
                if not os.path.isfile(f"{ckpt}/best_model.tar"):
                    raise AssertionError(f"{method}: no best_model.tar")
                if not method.startswith("maml"):
                    t0 = time.perf_counter()
                    written = save_features.main(args)
                    wall["features"] = time.perf_counter() - t0
                    path = save_features.feature_file_path(
                        parse_args("save_features", args))
                    if cache_file(path) != written:
                        raise AssertionError(f"{method}: no cache {path}")
                t0 = time.perf_counter()
                acc = test.main(args + ["--n_iter=600", "--repeat=1"])[0]
                wall["test"] = time.perf_counter() - t0
                accs = {"test": acc}
                if method in ("maml", "relationnet"):
                    t0 = time.perf_counter()
                    n = 32 if method == "maml" else 100
                    accs["adaptation"] = test.main(args + [
                        f"--n_iter={n}", "--repeat=1", "--adaptation"])[0]
                    wall["test --adaptation"] = time.perf_counter() - t0
                results[method] = accs
                print(f"zoo phase: {method}: {len(values)} train steps, "
                      f"losses {values[0]:.4f} -> {values[-1]:.4f}; "
                      f"accuracy {accs}; seconds " + ", ".join(
                          f"{k} {v:.2f}" for k, v in wall.items())
                      + f" [{card}]", flush=True)
        finally:
            base.EpisodicMethod.train_step, BaselineTrain.train_step = steps
            os.chdir(cwd)
            dd._CACHE.clear()
    low = {m: a for m, a in results.items() if not a["test"] > 50.0}
    if low:
        raise AssertionError(f"accuracy not above 50%: {low}")

# -- episode parallelism and the profiling helpers -----------------------------

PAR_ARGS = ["--dataset=miniImagenet", "--model=Conv4", "--method=DKT",
            "--episode_batch=32", "--n_train_episodes=64", "--stop_epoch=1"]


def build_main_model(device, episode: torch.Tensor, seed: int = 0):
    """DKT on Conv4 (bncossim, bf16 trunk), the main path's model, for
    episodes shaped like `episode` [n_way, S+Q, H, W, 3]."""
    from deep_kernel_transfer_tpu_torch.methods import DKT
    from deep_kernel_transfer_tpu_torch.models import Conv4

    return DKT(Conv4(), episode.shape[0], MAIN_SHOT, kernel_type="bncossim",
               feature_dtype="bfloat16", device=device).init(
                   episode, torch.Generator().manual_seed(seed))


def _join_card_group(rank: int, n: int, port: int,
                     device_type: str) -> torch.device:
    """Rank `rank` of n on the one card (or the CPU): TF32 off, the card
    made current, a gloo group with the device's tensors joined (NCCL
    refuses several ranks on one GPU). Returns the device."""
    import torch.distributed as dist

    device = torch.device(device_type)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    return device


def run_ranks_on_card(target, n: int, *args, timeout: float = 600) -> float:
    """target(rank, n, port, *args) in n processes started with `spawn`;
    raises when a rank fails. Returns the seconds, the ranks' start
    included."""
    from deep_kernel_transfer_tpu_torch.parallel.mesh import free_port

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=(r, n, port) + args)
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"the {n} ranks exited with {codes}")
    return time.perf_counter() - t0


def _weights_spread(state: dict) -> float:
    """The largest difference of any entry of `state` between the ranks
    (a collective)."""
    import torch.distributed as dist

    flat = torch.cat([v.reshape(-1).float() for v in state.values()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    spread = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    return float(spread)


def _two_rank_step(rank: int, n: int, port: int, inputs: str, out: str,
                   device_type: str) -> None:
    """Rank `rank` of two on the one card (or the CPU), over gloo with the
    device's tensors: rank 0's weights broadcast, one sharded train step
    on the rank's half of the batch; rank 0 saves the loss, the averaged
    gradients, the weights after the step, the largest difference of any
    weight between the ranks and the kernel launches of both."""
    import torch.distributed as dist

    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
    from deep_kernel_transfer_tpu_torch.parallel import (
        Mesh, make_sharded_train_step, replicate_tree, shard_episode_batch)

    device = _join_card_group(rank, n, port, device_type)
    try:
        blob = torch.load(inputs, map_location=device, weights_only=True)
        # rank 1 draws other weights: replicate_tree must overwrite them
        model = build_main_model(device, blob["x"][0], seed=rank)
        if rank == 0:
            model.load_state_dict(blob["state"])
        mesh = Mesh(rank, n, device)
        replicate_tree([model, model.optimizer], mesh)
        fused_linear_mll.launches = 0
        m = make_sharded_train_step(model, mesh)(
            shard_episode_batch(blob["x"], mesh))
        torch.cuda.synchronize()
        spread = _weights_spread(model.state_dict())
        launches = torch.tensor([float(fused_linear_mll.launches)],
                                device=device)
        dist.all_reduce(launches)
        if rank == 0:
            torch.save({"loss": float(m["loss"]),
                        "grads": {n: p.grad.cpu()
                                  for n, p in model.named_parameters()},
                        "state": {k: v.cpu()
                                  for k, v in model.state_dict().items()},
                        "spread": spread, "launches": int(launches)},
                       out)
    finally:
        dist.destroy_process_group()


def one_process_step(model, *batch, parts: int = 1) -> dict:
    """The reference of a sharded step: the state before, the loss, the
    gradients and the state after one step of `model` on the whole batch,
    on the CPU. With parts > 1, the sharded step's arithmetic in one
    process: the loss, gradients and BatchNorm statistics of each of the
    ranks' parts of the batch in turn, combined as the ranks combine them
    (the mean; the sum for MAML's summed loss), then the update."""
    from deep_kernel_transfer_tpu_torch.methods.base import merge_stats
    from deep_kernel_transfer_tpu_torch.parallel.mesh import loss_reduction

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if parts == 1:
        loss = float(model.train_step(*batch)["loss"])
    else:
        summed = loss_reduction(model) == "sum"
        model.optimizer.zero_grad(set_to_none=True)
        losses, stats = [], []
        for xb in batch[0].chunk(parts):
            part_loss, part_stats = model.batch_loss_train(xb)
            (part_loss if summed else part_loss / parts).backward()
            losses.append(float(part_loss.detach()))
            stats.append(part_stats or {})
        loss = sum(losses) if summed else sum(losses) / parts
        model.optimizer.step()
        merge_stats({bn: tuple(torch.stack([s[bn][i] for s in stats]).mean(0)
                               for i in (0, 1)) for bn in stats[0]})
    return {"state": state, "loss": loss,
            "grads": {n: p.grad.to("cpu", copy=True)
                      for n, p in model.named_parameters()},
            "after": {k: v.to("cpu", copy=True)
                      for k, v in model.state_dict().items()}}


def sharded_agreement(got: dict, want: dict, lrs: dict) -> tuple:
    """(loss relative difference, gradient distance as a fraction of the
    one-process gradient's norm, the tensor furthest off in its own norm,
    largest weight difference after the step in units of 2 lr) of a
    sharded step against the one-process step."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    # the gradient as one vector, against its norm: in bf16 the conv
    # biases before a train-mode BatchNorm (exact gradient 0) hold rounding
    # noise of 1e-3, which no per-tensor scale separates from an error
    names = sorted(want["grads"])
    diff = torch.cat([(got["grads"][n] - want["grads"][n]).reshape(-1)
                      for n in names])
    grad_rel = float(diff.norm() / torch.cat(
        [want["grads"][n].reshape(-1) for n in names]).norm())
    worst = max(names, key=lambda n: float(
        (got["grads"][n] - want["grads"][n]).norm()
        / (want["grads"][n].norm() + 1e-12)))
    step_dev = max(float((got["state"][n] - want["after"][n]).abs().max()
                         / (2 * lr)) for n, lr in lrs.items())
    return loss_rel, grad_rel, worst, step_dev


# bf16 trunk: the convolutions' gradients of 16 episodes round to bf16
# (2^-8 relative) apart from those of 32, by other algorithms; a missing
# or wrong average is off by tens of percent. Adam's first step moves a
# weight by lr * sign(g): a flipped sign moves it 2 lr
SHARDED_LIMITS = {"loss": 1e-3, "grad": 2e-2, "step": 1.01}


def check_sharded_agreement(label: str, agreement: tuple) -> None:
    loss_rel, grad_rel, _, step_dev = agreement
    if not (loss_rel < SHARDED_LIMITS["loss"]
            and grad_rel < SHARDED_LIMITS["grad"]
            and step_dev < SHARDED_LIMITS["step"]):
        raise AssertionError(f"{label} disagrees with one process")


def dkt_lrs(model) -> dict:
    return {n: model.gp_lr if n.startswith("gp.") else model.feature_lr
            for n, _ in model.named_parameters()}


def check_two_ranks_one_card(device, card: str, x: torch.Tensor) -> int:
    """(b): two processes on the one card over gloo (NCCL refuses two ranks
    on one GPU), 16 episodes each, against the one-process step on the 32.
    Returns the ranks' kernel launches."""
    ref = build_main_model(device, x[0], seed=1)
    lrs = dkt_lrs(ref)
    one = one_process_step(ref, x)
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        inputs, out = os.path.join(d, "in.pt"), os.path.join(d, "out.pt")
        torch.save({"state": one["state"], "x": x}, inputs)
        wall = run_ranks_on_card(_two_rank_step, 2, inputs, out, device.type)
        two = torch.load(out, weights_only=True)
    agreement = sharded_agreement(two, one, lrs)
    loss_rel, grad_rel, worst, step_dev = agreement
    print(f"episode parallel (b), 2 ranks on one card over gloo, 16 "
          f"episodes each: loss {two['loss']!r} against the one-process "
          f"{one['loss']!r} (relative {loss_rel:.3e}), averaged gradient "
          f"{grad_rel:.3e} of the one-process gradient's norm away from it "
          f"(the tensor furthest off in its own norm: {worst}), weights "
          f"after the Adam step within "
          f"{step_dev:.3e} x 2 lr, largest weight difference between the "
          f"ranks {two['spread']!r}, fused_linear_mll launches "
          f"{two['launches']} (both ranks), {wall:.1f} s with the ranks' "
          f"start [{card}]", flush=True)
    check_sharded_agreement("two ranks", agreement)
    if two["spread"] != 0.0:
        raise AssertionError("the ranks' weights differ after the step")
    if two["launches"] != 2:
        raise AssertionError("want one fused-MLL launch on each rank")
    return two["launches"]


TP_TIMED_STEPS = 3
# episodes of the TP part: at the main path's 32, four ranks of 16
# episodes each hold about 19 GiB (peak and the allocator's reserve) and
# do not fit beside each other on the 80 GB card, so the part is cut to 16
TP_B = 16


def tp_gradients_and_bytes(model, mesh) -> tuple:
    """(every gradient on the host, a tp chunk's all-gathered; the bytes
    this rank holds of the tp-sharded weights with Adam's two moments of
    them; for each sharded weight, whether the tp ranks hold different
    chunks) after a tensor-parallel step (a collective over the tp
    group)."""
    import torch.distributed as dist

    from deep_kernel_transfer_tpu_torch.parallel.mesh import tp_chunks

    chunks = tp_chunks(model)
    grads, local, distinct = {}, 0, []
    for name, p in model.named_parameters():
        g = p.grad
        if name in chunks:
            g = chunks[name].gather(g)
            parts = [torch.empty_like(p) for _ in range(mesh.tp)]
            dist.all_gather(parts, p.detach(), group=mesh.tp_group)
            distinct.append(not torch.equal(parts[0], parts[1]))
            adam = model.optimizer.state[p]
            local += sum(t.numel() * t.element_size() for t in
                         (p, adam["exp_avg"], adam["exp_avg_sq"]))
        grads[name] = g.to("cpu", copy=True)
    return grads, local, distinct


def _tp_rank_step(rank: int, n: int, port: int, inputs: str, out: str,
                  device_type: str) -> None:
    """Rank `rank` of dp=2 x tp=2 on the one card over gloo: rank 0's
    weights broadcast, the parameters that tensor_sharding_rules(min_size=
    1 << 10) picks stored as this rank's tp chunk, one tensor-parallel
    step on the dp group's half of the batch, then TP_TIMED_STEPS more,
    timed. Rank 0 saves the loss, the averaged gradient (chunks
    gathered), the gathered weights, their largest difference between the
    ranks and each rank's bytes, chunks, launches, peak and ms."""
    import torch.distributed as dist

    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
    from deep_kernel_transfer_tpu_torch.parallel import (
        gather_state, grid_mesh, make_sharded_train_step, replicate_tree,
        shard_episode_batch, tensor_sharding_rules)

    device = _join_card_group(rank, n, port, device_type)
    try:
        blob = torch.load(inputs, map_location=device, weights_only=True)
        model = build_main_model(device, blob["x"][0], seed=rank)
        if rank == 0:
            model.load_state_dict(blob["state"])
        mesh = grid_mesh(2, 2, device)
        replicate_tree([model, model.optimizer], mesh)
        rules = tensor_sharding_rules(model, mesh, min_size=1 << 10)
        replicated = sum(3 * p.numel() * p.element_size()  # p, Adam's two
                         for name, p in model.named_parameters()
                         if rules[name] is not None)
        step = make_sharded_train_step(model, mesh, param_shardings=rules)
        xb = shard_episode_batch(blob["x"], mesh)
        torch.cuda.reset_peak_memory_stats(device)
        fused_linear_mll.launches = 0
        m = step(xb)
        torch.cuda.synchronize()
        launches = fused_linear_mll.launches
        grads, local, distinct = tp_gradients_and_bytes(model, mesh)
        # copies: the timed steps below move the weights
        state = {k: v.to("cpu", copy=True)
                 for k, v in gather_state(model).items()}
        spread = _weights_spread(state)
        peak = torch.cuda.max_memory_allocated(device)
        reserved = torch.cuda.max_memory_reserved(device)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(TP_TIMED_STEPS):
            step(xb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / TP_TIMED_STEPS * 1e3
        facts = {"local": local, "replicated": replicated,
                 "distinct": all(distinct) and bool(distinct),
                 "launches": launches, "peak": peak, "reserved": reserved,
                 "ms": ms,
                 "n_sharded": len(distinct)}
        everyone = [None] * n
        dist.all_gather_object(everyone, facts)
        if rank == 0:
            torch.save({"loss": float(m["loss"]), "grads": grads,
                        "state": state, "spread": spread,
                        "ranks": everyone}, out)
    finally:
        dist.destroy_process_group()


def check_tensor_parallel_one_card(device, card: str, x: torch.Tensor) -> int:
    """(d): four processes on the one card over gloo, dp=2 x tp=2, the
    main path's model with its conv weights (and their Adam moments)
    stored as tp chunks, the first TP_B episodes of x split over the two
    dp groups, against the one-process step on them. Returns the ranks'
    kernel launches."""
    x = x[:TP_B]
    ref = build_main_model(device, x[0], seed=1)
    lrs = dkt_lrs(ref)
    one = one_process_step(ref, x)
    one_ms = cuda_ms(lambda: ref.train_step(x), iters=TP_TIMED_STEPS,
                     warmup=1)
    del ref
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        inputs, out = os.path.join(d, "in.pt"), os.path.join(d, "out.pt")
        torch.save({"state": one["state"], "x": x}, inputs)
        wall = run_ranks_on_card(_tp_rank_step, 4, inputs, out, device.type)
        tp = torch.load(out, weights_only=True)
    agreement = sharded_agreement(tp, one, lrs)
    loss_rel, grad_rel, worst, step_dev = agreement
    ranks = tp["ranks"]
    launches = sum(r["launches"] for r in ranks)
    print(f"tensor parallel (d), dp=2 x tp=2, 4 ranks on one card over "
          f"gloo, {x.shape[0] // 2} episodes a dp group, "
          f"{ranks[0]['n_sharded']} conv "
          f"weights sharded (min_size 1 << 10): loss {tp['loss']!r} against "
          f"the one-process {one['loss']!r} (relative {loss_rel:.3e}), "
          f"averaged gradient {grad_rel:.3e} of the one-process gradient's "
          f"norm away from it (furthest off: {worst}), weights after the "
          f"step within {step_dev:.3e} x 2 lr, largest gathered-weight "
          f"difference between the ranks {tp['spread']!r}; sharded leaves "
          f"with Adam's moments {[r['local'] for r in ranks]} bytes a rank "
          f"against {ranks[0]['replicated']} replicated; the tp ranks of a "
          f"group hold different chunks: "
          f"{all(r['distinct'] for r in ranks)}; fused_linear_mll launches "
          f"{[r['launches'] for r in ranks]}; peak "
          f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB a rank, "
          f"{sum(r['peak'] for r in ranks) / 2**30:.2f} together, "
          f"{sum(r['reserved'] for r in ranks) / 2**30:.2f} reserved; "
          f"{wall:.1f} s with the ranks' start [{card}]", flush=True)
    step_ms = statistics.median(r["ms"] for r in ranks)
    print(f"tensor parallel (d): {step_ms:.3f} ms a step (median over the ranks of {TP_TIMED_STEPS} "
          f"steps, host clock; four ranks share one card, so this checks "
          f"the path, not its speed) beside the one-process step's "
          f"{one_ms:.3f} ms (CUDA events, {TP_TIMED_STEPS} steps) "
          f"[{card}]", flush=True)
    check_sharded_agreement("the tensor-parallel step", agreement)
    if tp["spread"] != 0.0:
        raise AssertionError("the ranks' gathered weights differ")
    if not all(r["local"] * 2 == r["replicated"] and r["distinct"]
               and r["n_sharded"] for r in ranks):
        raise AssertionError("a rank does not hold one tp chunk of the "
                             "sharded leaves and their Adam moments")
    if launches != 4:
        raise AssertionError("want one fused-MLL launch on each rank")
    return launches


ZOO_PARALLEL = ("protonet", "matchingnet", "relationnet", "maml")
ZOO_PARALLEL_B = 4  # episodes: two a rank, MAML's n_task
ZOO_ACC_LIMIT = 2.5  # points an episode: two of its 80 queries


def build_zoo_method(name: str, device, example: torch.Tensor,
                     feature_dtype: str | None = None):
    """A comparison method as the CLIs build it (ZOO_ARGS: Conv4, 84 px,
    5-way 5-shot), initialised from a fixed seed; `feature_dtype` replaces
    the trunk's dtype (bf16 but MAML's and the baselines' f32)."""
    from deep_kernel_transfer_tpu_torch import factory
    from deep_kernel_transfer_tpu_torch.io_utils import parse_args

    params = parse_args("train", ZOO_ARGS + [f"--method={name}"])
    method = factory.build_method(params, MAIN_WAY, MAIN_SHOT, device)
    if feature_dtype is not None:
        method.feature_dtype = getattr(torch, feature_dtype)
    return method.init(example, torch.Generator().manual_seed(0))


def _zoo_ranks(rank: int, n: int, port: int, inputs: str, out: str,
               device_type: str, feature_dtype: str | None,
               cudnn: bool) -> None:
    """Rank `rank` of two on the one card over gloo, cuDNN deterministic:
    for each comparison method, its weights loaded, one sharded step on
    the rank's episodes and the sharded eval of all; BaselineTrain's step
    on the rank's half of the minibatch. Rank 0 saves the losses,
    gradients, states and accuracies."""
    import torch.distributed as dist

    from deep_kernel_transfer_tpu_torch.parallel import (
        Mesh, make_sharded_eval, make_sharded_train_step,
        shard_episode_batch)

    device = _join_card_group(rank, n, port, device_type)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.enabled = cudnn
    try:
        blob = torch.load(inputs, map_location=device, weights_only=True)
        mesh = Mesh(rank, n, device)
        results = {}
        for name, state in blob["states"].items():
            batch = ((blob["x_base"], blob["y_base"]) if name == "baseline"
                     else (blob["x"],))
            method = build_zoo_method(name, device, batch[0][0]
                                      if name != "baseline" else batch[0],
                                      feature_dtype)
            method.load_state_dict(state)
            m = make_sharded_train_step(method, mesh)(
                *(shard_episode_batch(t, mesh) for t in batch))
            results[name] = {
                "loss": float(m["loss"]),
                "grads": {k: p.grad.cpu()
                          for k, p in method.named_parameters()},
                "state": {k: v.cpu()
                          for k, v in method.state_dict().items()}}
            if name != "baseline":
                results[name]["accs"] = make_sharded_eval(method, mesh)(
                    shard_episode_batch(blob["x"], mesh)).cpu()
            results[name]["spread"] = _weights_spread(method.state_dict())
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def zoo_episodes(device) -> tuple:
    """(x [4, 5, 21, 84, 84, 3] uint8 episodes, x_base [16, 84, 84, 3],
    y_base [16]) of parts (e) and (f), from one seed on the card."""
    gen = torch.Generator(device=device).manual_seed(9)
    x = torch.randint(0, 256, (ZOO_PARALLEL_B, MAIN_WAY, MAIN_SHOT + 16,
                               MAIN_PX, MAIN_PX, 3), generator=gen,
                      device=device, dtype=torch.uint8)
    x_base = torch.randint(0, 256, (16, MAIN_PX, MAIN_PX, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    y_base = torch.randint(0, 64, (16,), generator=gen, device=device)
    return x, x_base, y_base


def check_zoo_two_ranks_one_card(device, card: str,
                                 feature_dtype: str | None = None,
                                 cudnn: bool = True) -> None:
    """(e): protonet, matchingnet, relationnet and maml, one sharded step
    and the sharded eval on two gloo ranks of the one card (4 episodes,
    two a rank), each against the same step in one process on the same
    episodes in the ranks' parts (one_process_step(parts=2)): the bf16
    trunks round differently at another batch size, and move the
    gradient by up to a third of its norm (PERF.md section 6), so
    the whole batch in one process is printed beside it, unchecked; and
    BaselineTrain's batch-sharded step (16 images, eight a rank,
    BatchNorm over the whole minibatch, f32) against its one-process step
    on the 16. cuDNN deterministic on both sides: without it MAML's
    second-order step does not repeat itself from run to run.
    `feature_dtype="float32"` runs every trunk in f32, and `cudnn=False`
    takes PyTorch's own convolutions and LSTMs for cuDNN's on both sides
    (ROADMAP C4: whether the whole batch's gradient in one process parts
    from the ranks' by more than f32 rounding, and whether cuDNN's choice
    of algorithm by batch size is what moves it). Not run by main():
    a probe, see the README."""
    x, x_base, y_base = zoo_episodes(device)
    label = ("(e)" if feature_dtype is None and cudnn else
             f"(e, {feature_dtype or 'default'} trunks, cuDNN "
             f"{'on' if cudnn else 'off'})")
    deterministic = torch.backends.cudnn.deterministic
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.enabled = cudnn
    try:
        ones, wholes, evals, lrs = {}, {}, {}, {}
        for name in ZOO_PARALLEL + ("baseline",):
            if name == "baseline":
                method = build_zoo_method(name, device, x_base,
                                          feature_dtype)
                ones[name] = one_process_step(method, x_base, y_base)
            else:
                method = build_zoo_method(name, device, x[0], feature_dtype)
                ones[name] = one_process_step(method, x, parts=2)
                whole = build_zoo_method(name, device, x[0], feature_dtype)
                whole.load_state_dict(ones[name]["state"])
                wholes[name] = one_process_step(whole, x)
                evals[name] = whole
            lrs[name] = {k: method.lr for k, _ in method.named_parameters()}
        with tempfile.TemporaryDirectory() as d:
            inputs, out = (os.path.join(d, "in.pt"),
                           os.path.join(d, "out.pt"))
            torch.save({"states": {k: v["state"] for k, v in ones.items()},
                        "x": x, "x_base": x_base, "y_base": y_base}, inputs)
            wall = run_ranks_on_card(_zoo_ranks, 2, inputs, out,
                                     device.type, feature_dtype, cudnn)
            two = torch.load(out, weights_only=True)
        failed = []
        for name, got in two.items():
            agreement = sharded_agreement(got, ones[name], lrs[name])
            loss_rel, grad_rel, worst, step_dev = agreement
            extra = ""
            if name != "baseline":
                evals[name].load_state_dict(got["state"])
                want = evals[name].batch_correct(x).cpu()
                if not (got["accs"].shape == want.shape and float(
                        (got["accs"] - want).abs().max()) <= ZOO_ACC_LIMIT):
                    failed.append(f"{name} eval")
                w_loss, w_grad, w_worst, _ = sharded_agreement(
                    got, wholes[name], lrs[name])
                extra = (f"; sharded eval of the {ZOO_PARALLEL_B} episodes "
                         f"{got['accs'].tolist()} against one process's "
                         f"{want.tolist()} on those weights; against the "
                         f"whole batch in one process (unchecked): loss "
                         f"{w_loss:.3e}, gradient {w_grad:.3e} of its norm "
                         f"(furthest off: {w_worst})")
            reference = ("the one-process step on the ranks' parts"
                         if name != "baseline" else
                         "the one-process step on the 16")
            print(f"episode parallel {label}, {name}, 2 ranks on one card "
                  f"over gloo: loss {got['loss']!r} against {reference} "
                  f"{ones[name]['loss']!r} (relative {loss_rel:.3e}), "
                  f"averaged gradient {grad_rel:.3e} of its norm away "
                  f"(furthest off: {worst}), weights after the step within "
                  f"{step_dev:.3e} x 2 lr, ranks' weights apart by at most "
                  f"{got['spread']!r}{extra} [{card}]", flush=True)
            try:
                check_sharded_agreement(name, agreement)
            except AssertionError:
                failed.append(name)
            if got["spread"] != 0.0:
                failed.append(f"{name} ranks' weights")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.enabled = enabled
    print(f"episode parallel {label}: the zoo's sharded steps in one "
          f"spawn, {wall:.1f} s with the ranks' start [{card}]", flush=True)
    if failed or set(two) != set(ones):
        raise AssertionError(f"the zoo's sharded steps disagree with one "
                             f"process: {failed}")


def check_zoo_split_in_float64(device) -> dict:
    """ROADMAP C4's arbiter at part (e)'s shapes, in one process: each of
    ZOO_PARALLEL's gradients on the whole batch of `zoo_episodes` against
    the combination of its halves' (the mean; the sum for MAML), with the
    parameters and trunk in float64 and in f32 (TF32 off). Prints, as
    fractions of the float64 gradient's norm, the float64 split gap and
    the f32 whole, f32 halves and f32 split gaps; raises unless the
    float64 gap is under 1e-9. Not run by main()."""
    from deep_kernel_transfer_tpu_torch.gp.kernels import full_f32
    from deep_kernel_transfer_tpu_torch.models.backbones import (
        preprocess_input)
    from deep_kernel_transfer_tpu_torch.parallel.mesh import loss_reduction

    x, _, _ = zoo_episodes(device)

    def gradient(method, xx, parts):
        total = None
        for share in xx.chunk(parts):
            method.zero_grad(set_to_none=True)
            method.batch_loss_train(share)[0].backward()
            g = torch.cat([p.grad.reshape(-1).double()
                           for p in method.parameters()])
            total = g if total is None else total + g
        return total / parts if loss_reduction(method) == "mean" else total

    def gap(a, b):
        return float((a - b).norm() / b.norm())

    gaps = {}
    with full_f32():
        for name in ZOO_PARALLEL:
            g = {}
            for dtype in (torch.float64, torch.float32):
                method = build_zoo_method(name, device, x[0],
                                          "float32").to(dtype)
                xx = x
                if name == "maml":  # its trunk takes its parameters' dtype
                    xx = preprocess_input(x).to(dtype)
                else:
                    method.feature_dtype = dtype
                for parts in (1, 2):
                    g[dtype, parts] = gradient(method, xx, parts)
            exact = g[torch.float64, 1]
            gaps[name] = (gap(g[torch.float64, 2], exact),
                          gap(g[torch.float32, 1], exact),
                          gap(g[torch.float32, 2], exact),
                          gap(g[torch.float32, 2], g[torch.float32, 1]))
            print(f"C4 in float64, {name}: float64 whole vs halves "
                  f"{gaps[name][0]:.3e}, float32 whole vs float64 "
                  f"{gaps[name][1]:.3e}, float32 halves vs float64 "
                  f"{gaps[name][2]:.3e}, float32 whole vs halves "
                  f"{gaps[name][3]:.3e}", flush=True)
    if not all(v[0] < 1e-9 for v in gaps.values()):
        raise AssertionError(f"the split moves the float64 gradient: {gaps}")
    return gaps


TP_ZOO = ("maml", "matchingnet")
LSTM_WEIGHTS = ("G_encoder.weight_ih_l0", "G_encoder.weight_hh_l0",
                "G_encoder.weight_ih_l0_reverse",
                "G_encoder.weight_hh_l0_reverse", "FCE.lstmcell.weight_ih",
                "FCE.lstmcell.weight_hh")


def _tp_zoo_ranks(rank: int, n: int, port: int, inputs: str, out: str,
                  device_type: str) -> None:
    """Rank `rank` of dp=2 x tp=2 on the one card over gloo, f32 trunks,
    cuDNN deterministic: for second-order MAML and MatchingNet, the
    weights loaded, the parameters that tensor_sharding_rules(min_size=
    1 << 10) picks stored as this rank's tp chunks (MatchingNet's six LSTM
    weights among them), one tensor-parallel step on the dp group's
    episodes. Rank 0 saves each method's loss, gradients (chunks
    gathered), gathered weights, their largest difference between the
    ranks, and each rank's sharded names and bytes."""
    import torch.distributed as dist

    from deep_kernel_transfer_tpu_torch.parallel import (
        gather_state, grid_mesh, make_sharded_train_step,
        shard_episode_batch, tensor_sharding_rules)
    from deep_kernel_transfer_tpu_torch.parallel.mesh import tp_chunks

    device = _join_card_group(rank, n, port, device_type)
    torch.backends.cudnn.deterministic = True
    try:
        blob = torch.load(inputs, map_location=device, weights_only=True)
        mesh = grid_mesh(2, 2, device)
        results = {}
        for name, state in blob["states"].items():
            method = build_zoo_method(name, device, blob["x"][0], "float32")
            method.load_state_dict(state)
            rules = tensor_sharding_rules(method, mesh, min_size=1 << 10)
            replicated = sum(3 * p.numel() * p.element_size()
                             for k, p in method.named_parameters()
                             if rules[k] is not None)
            m = make_sharded_train_step(method, mesh, param_shardings=rules)(
                shard_episode_batch(blob["x"], mesh))
            grads, local, distinct = tp_gradients_and_bytes(method, mesh)
            state = {k: v.to("cpu", copy=True)
                     for k, v in gather_state(method).items()}
            facts = {"local": local, "replicated": replicated,
                     "distinct": all(distinct) and bool(distinct),
                     "sharded": sorted(tp_chunks(method))}
            everyone = [None] * n
            dist.all_gather_object(everyone, facts)
            results[name] = {"loss": float(m["loss"]), "grads": grads,
                             "state": state, "ranks": everyone,
                             "spread": _weights_spread(state)}
            del method
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


def check_tensor_parallel_zoo_one_card(device, card: str) -> None:
    """(f): second-order MAML and MatchingNet on four gloo ranks of the one
    card, dp=2 x tp=2 (two episodes a dp group), f32 trunks, cuDNN
    deterministic, each against the same step in one process on the dp
    groups' parts (one_process_step(parts=2)) at (e)'s bounds: MAML
    differentiates through its inner gradient, and MatchingNet's LSTM
    weights are tp chunks. Prints the bytes a rank holds of the sharded
    weights with Adam's moments against the replicated bytes."""
    x, _, _ = zoo_episodes(device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ones, lrs = {}, {}
        for name in TP_ZOO:
            method = build_zoo_method(name, device, x[0], "float32")
            ones[name] = one_process_step(method, x, parts=2)
            lrs[name] = {k: method.lr for k, _ in method.named_parameters()}
            del method
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as d:
            inputs, out = (os.path.join(d, "in.pt"),
                           os.path.join(d, "out.pt"))
            torch.save({"states": {k: v["state"] for k, v in ones.items()},
                        "x": x}, inputs)
            wall = run_ranks_on_card(_tp_zoo_ranks, 4, inputs, out,
                                     device.type)
            tp = torch.load(out, weights_only=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    failed = []
    for name, got in tp.items():
        agreement = sharded_agreement(got, ones[name], lrs[name])
        loss_rel, grad_rel, worst, step_dev = agreement
        ranks = got["ranks"]
        lstm = [k for k in LSTM_WEIGHTS if k in ranks[0]["sharded"]]
        print(f"tensor parallel (f), {name}, dp=2 x tp=2, 4 ranks on one "
              f"card over gloo, f32 trunk: {len(ranks[0]['sharded'])} "
              f"weights sharded ({len(lstm)} of them LSTM weights): loss "
              f"{got['loss']!r} against the one-process step on the dp "
              f"groups' parts {ones[name]['loss']!r} (relative "
              f"{loss_rel:.3e}), gradient {grad_rel:.3e} of its norm away "
              f"(furthest off: {worst}), weights after the step within "
              f"{step_dev:.3e} x 2 lr, gathered weights apart between the "
              f"ranks by at most {got['spread']!r}; sharded weights with "
              f"Adam's moments {[r['local'] for r in ranks]} bytes a rank "
              f"against {ranks[0]['replicated']} replicated [{card}]",
              flush=True)
        try:
            check_sharded_agreement(name, agreement)
        except AssertionError:
            failed.append(name)
        if got["spread"] != 0.0:
            failed.append(f"{name} ranks' weights")
        if not all(r["local"] * 2 == r["replicated"] and r["distinct"]
                   and r["sharded"] == ranks[0]["sharded"] for r in ranks):
            failed.append(f"{name} storage")
        if name == "matchingnet" and len(lstm) != len(LSTM_WEIGHTS):
            failed.append("matchingnet's LSTM weights")
    print(f"tensor parallel (f): both methods in one spawn, {wall:.1f} s "
          f"with the ranks' start [{card}]", flush=True)
    if failed or set(tp) != set(TP_ZOO):
        raise AssertionError(f"the tensor-parallel zoo steps disagree with "
                             f"one process: {failed}")


def check_traced_spans(model, batches, card: str) -> int:
    """A torch.profiler trace (utils/profiling.py::trace) of two train
    steps of `model` on `batches`: each `dkt.` span of the step opened
    twice and the fused MLL launched twice. Returns the launches."""
    from torch.autograd import DeviceType

    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
    from deep_kernel_transfer_tpu_torch.utils.profiling import (SPAN_PREFIX,
                                                                trace)

    with tempfile.TemporaryDirectory() as d:
        fused_linear_mll.launches = 0
        with trace(d, model.device) as prof:
            for i in range(2):
                model.train_step(batches[i])
            torch.cuda.synchronize()
        files = {f: os.path.getsize(os.path.join(d, f))
                 for f in os.listdir(d)}
        n_p = fused_linear_mll.launches
    spans = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == DeviceType.CPU and e.name.startswith(SPAN_PREFIX))
    print(f"profiling: trace files {files}; spans {dict(spans)}; "
          f"fused_linear_mll launches {n_p} [{card}]", flush=True)
    if not files or not sum(files.values()):
        raise AssertionError("the trace directory is empty")
    step_spans = ("step", "forward", "backward", "update", "trunk", "gp")
    if n_p != 2 or any(spans[SPAN_PREFIX + s] != 2 for s in step_spans):
        raise AssertionError("the traced steps did not open each span of "
                             "the step once a step")
    return n_p


def drive_parallel_path(device, card: str) -> dict:
    """Episode parallelism at the main path's full width (DKT, Conv4,
    bncossim, 5w5s15q, 84 px, B = 32, bf16 trunk), then the profiling
    helpers. Returns the fused MLL's launches of (a), (b), (c) and the
    profiled steps.

    (a) NCCL with one rank: 5 sharded steps against 5 plain train_steps
        from the same weights on the same episodes, the sharded step timed
        against the plain one in turns;
    (b) two ranks on the one card over gloo (check_two_ranks_one_card);
    (c) `train.main --n_devices=1` (resolve_mesh: the single-device path)
        on a small generated miniImagenet layout, 2 steps; and
        --n_devices=2, which must refuse the one card;
    (d) four ranks on the one card over gloo, dp=2 x tp=2, the conv
        weights stored as tp chunks (check_tensor_parallel_one_card);
    (e) the comparison methods and BaselineTrain on two gloo ranks
        (check_zoo_two_ranks_one_card);
    (f) second-order MAML and MatchingNet on four gloo ranks, dp=2 x
        tp=2 (check_tensor_parallel_zoo_one_card);
    then the port's spans in a trace of two train steps
    (check_traced_spans)."""
    import torch.distributed as dist

    from deep_kernel_transfer_tpu_torch import train
    from deep_kernel_transfer_tpu_torch.data import device_dataset as dd
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
    from deep_kernel_transfer_tpu_torch.parallel import (
        make_mesh, make_sharded_train_step, shard_episode_batch)

    gen = torch.Generator(device=device).manual_seed(7)
    shape = (MAIN_B, MAIN_WAY, MAIN_SHOT + MAIN_QUERY, MAIN_PX, MAIN_PX, 3)
    batches = [torch.randint(0, 256, shape, generator=gen, device=device,
                             dtype=torch.uint8) for _ in range(2)]
    launches = 0

    # (a)
    plain = build_main_model(device, batches[0][0])
    model = build_main_model(device, batches[0][0], seed=1)
    model.load_state_dict(plain.state_dict())
    mesh = make_mesh(1, device)
    try:
        step = make_sharded_train_step(model, mesh)
        want = [float(plain.train_step(batches[i % 2])["loss"])
                for i in range(5)]
        fused_linear_mll.launches = 0
        got = [step(shard_episode_batch(batches[i % 2], mesh))["loss"]
               for i in range(5)]
        torch.cuda.synchronize()
        n_a = fused_linear_mll.launches
        got = [float(v) for v in got]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        print(f"episode parallel (a), NCCL, one rank: 5 sharded steps, "
              f"losses {got}; plain train_step {want}; largest relative "
              f"difference {rel:.3e}; fused_linear_mll launches {n_a}",
              flush=True)
        if not all(math.isfinite(v) for v in got) or not rel < 1e-3:
            raise AssertionError("the sharded step disagrees with the plain")
        if n_a != 5:
            raise AssertionError(f"want 5 fused-MLL launches, got {n_a}")
        launches += n_a
        times = ms_in_turns(
            {"sharded": lambda: step(batches[0]),
             "plain": lambda: plain.train_step(batches[0])},
            rounds=4, iters=5)
        for name, (ms, lo, hi) in times.items():
            print(f"train step, {name}, one rank: {ms:.3f} ms (median of 4 "
                  f"turns, {lo:.3f}-{hi:.3f}) [{card}]", flush=True)
    finally:
        dist.destroy_process_group()
    del model
    torch.cuda.empty_cache()

    # (b)
    launches += check_two_ranks_one_card(device, card, batches[0])

    # (c)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        os.chdir(root)
        try:
            write_cli_dataset(root, splits=(("base", 10), ("val", 5),
                                            ("novel", 5)),
                              n_images=40, canvas_base=False)
            fused_linear_mll.launches = 0
            t0 = time.perf_counter()
            train.main(PAR_ARGS + ["--n_devices=1"])
            torch.cuda.synchronize()
            n_c = fused_linear_mll.launches
            print(f"episode parallel (c): train.main --n_devices=1, 2 steps "
                  f"of 32 episodes and the validation in "
                  f"{time.perf_counter() - t0:.2f} s, fused_linear_mll "
                  f"launches {n_c} [{card}]", flush=True)
            if n_c != 2 or not os.path.isfile(
                    "save/checkpoints/miniImagenet/Conv4_DKT_5way_5shot/"
                    "best_model.tar"):
                raise AssertionError("train --n_devices=1 did not train")
            launches += n_c
            try:
                train.main(PAR_ARGS + ["--n_devices=2"])
            except ValueError as e:
                print(f"episode parallel (c): --n_devices=2 on one card "
                      f"refused: {e}", flush=True)
            else:
                raise AssertionError("--n_devices=2 ran on one card")
        finally:
            os.chdir(cwd)
            dd._CACHE.clear()

    # (d), (e) and (f)
    torch.cuda.empty_cache()
    launches += check_tensor_parallel_one_card(device, card, batches[0])
    check_zoo_two_ranks_one_card(device, card)
    check_tensor_parallel_zoo_one_card(device, card)

    # the port's spans in a trace of two train steps
    n_p = check_traced_spans(plain, batches, card)
    return {"fused_linear_mll": launches + n_p}


# -- the regression track ------------------------------------------------------

REG_EPOCHS, REG_TEST_EPOCHS = 10, 10
REG_KINDS = {"DKT rbf": ["--method=DKT"],
             "DKT spectral": ["--method=DKT", "--spectral"],
             "transfer": ["--method=transfer"]}


def kernel_counters() -> list:
    """Every kernel wrapper of the port, each with its launch count."""
    from deep_kernel_transfer_tpu_torch.ops.blocked_cholesky import (
        blocked_cholesky)
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll
    from deep_kernel_transfer_tpu_torch.ops.hbm_cholesky import (
        fused_gram_cholesky, fused_gram_cholesky_tiled, hbm_blocked_cholesky)

    return [fused_linear_mll, blocked_cholesky, hbm_blocked_cholesky,
            fused_gram_cholesky, fused_gram_cholesky_tiled]


def recording_steps(classes_and_names, log: list):
    """Wrap each class's step method to append (time, loss) to `log`;
    returns a function that restores them."""
    saved = []
    for cls, name in classes_and_names:
        step = getattr(cls, name)
        saved.append((cls, name, step))

        def wrapped(self, *a, _step=step):
            out = _step(self, *a)
            loss = out["loss"] if isinstance(out, dict) else out
            log.append((time.perf_counter(), loss))
            return out
        setattr(cls, name, wrapped)

    def restore():
        for cls, name, step in saved:
            setattr(cls, name, step)
    return restore


def check_regression_cpu_vs_card(device, card: str, xb, yb) -> None:
    """DKT rbf, DKT spectral and transfer with the same weights (one seeded
    init each, on the CPU and on the card) on the same 24-person batch:
    the mean loss within 1e-4 relative and every gradient within 2e-2 of
    the largest entry of the CPU's (a floor of 1e-6 of the largest
    gradient of the model), the path's guard against TF32 and layout
    slips."""
    from deep_kernel_transfer_tpu_torch import train_regression
    from deep_kernel_transfer_tpu_torch.io_utils import parse_args_regression

    for kind, flags in REG_KINDS.items():
        params = parse_args_regression("train_regression", flags)
        out = []
        for dev in ("cpu", device):
            model = train_regression.init_regression_method(params, dev)
            loss = model.batch_loss(xb.to(model.device), yb.to(model.device))
            loss.backward()
            loss = loss.detach()
            out.append((loss.item(), {k: p.grad.detach().cpu().double()
                                      for k, p in model.named_parameters()}))
        (l_cpu, g_cpu), (l_dev, g_dev) = out
        top = max(float(g.abs().max()) for g in g_cpu.values())
        errs = {k: float((g_dev[k] - g).abs().max())
                / max(float(g.abs().max()), 1e-6 * top)
                for k, g in g_cpu.items()}
        loss_err = abs(l_dev - l_cpu) / abs(l_cpu)
        worst = max(errs, key=errs.get)
        print(f"regression phase: {kind} CPU vs card: loss {l_cpu!r} / "
              f"{l_dev!r} (relative {loss_err:.3e}), largest gradient "
              f"difference {errs[worst]:.3e} ({worst}) [{card}]", flush=True)
        if not loss_err < 1e-4 or not errs[worst] < 2e-2:
            raise AssertionError(f"{kind}: the card disagrees with the CPU")


def profile_regression_epoch(model, card: str) -> None:
    """torch.profiler over one --task_batch=1 epoch of DKT (the draw, the
    copy to the card, 24 per-person steps): device busy share of the wall,
    the top device rows, and the host synchronisations (each
    `aten::_local_scalar_dense` is one, psd_safe_cholesky's bool() among
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deep_kernel_transfer_tpu_torch.data.qmul import get_batch, train_people

    def epoch():
        xb, yb = get_batch(train_people, np.random.RandomState(12345))
        model.unbatched_train_step(torch.from_numpy(xb).to(model.device),
                                   torch.from_numpy(yb).to(model.device))

    epoch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    dev = sorted([e for e in rows if e.device_type == DeviceType.CUDA],
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    syncs = {e.key: (e.count, e.cpu_time_total / 1e3) for e in rows
             if e.key in ("aten::_local_scalar_dense", "aten::item",
                          "cudaStreamSynchronize", "cudaMemcpyAsync")}
    print(f"regression phase: profile of one {model.kernel_type} epoch (24 "
          f"per-person steps): wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%); host syncs "
          f"(calls, CPU ms) {syncs} [{card}]", flush=True)
    for e in dev[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} "
              f"calls  {e.key[:100]}", flush=True)


def drive_regression_path(device, card: str) -> None:
    """The regression track at full width, cut in depth, in a temporary
    working directory: the synthetic QMUL grid (29 people x 13 pitches x
    19 angles, 100-px JPEGs of benchmarks/regression_real.py's
    render_face, written by 8 threads); the CPU against the card on one
    24-person batch; `train_regression.main` (Conv3, 24 people x 19 points,
    --task_batch=1) for REG_EPOCHS epochs each of DKT rbf, DKT --spectral
    and transfer, then `test_regression.main --n_support=5
    --n_test_epochs=10` on each checkpoint, which must give the trained
    model's own MSE; ms a per-person step and a batched 24-person step
    (CUDA events), s an epoch, peak GiB, a profile of one epoch. Checks
    finite losses, the reference layouts and that no kernel of the port
    launched."""
    from deep_kernel_transfer_tpu_torch import test_regression, train_regression
    from deep_kernel_transfer_tpu_torch.benchmarks.regression_real import (
        make_synthetic_qmul)
    from deep_kernel_transfer_tpu_torch.data import qmul
    from deep_kernel_transfer_tpu_torch.factory import regression_checkpoint_dir
    from deep_kernel_transfer_tpu_torch.io_utils import parse_args_regression
    from deep_kernel_transfer_tpu_torch.methods import (DKTRegression,
                                                        FeatureTransfer)

    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    log: list = []
    restore = recording_steps([(DKTRegression, "unbatched_train_step"),
                               (DKTRegression, "train_step"),
                               (FeatureTransfer, "train_step")], log)
    cwd = os.getcwd()
    results = {}
    with tempfile.TemporaryDirectory() as root:
        try:
            t0 = time.perf_counter()
            n = make_synthetic_qmul(root, threads=8)
            print(f"regression phase: synthetic QMUL grid, {n} JPEGs in "
                  f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
            os.chdir(root)
            xb, yb = qmul.get_batch(qmul.train_people,
                                    np.random.RandomState(0))
            xb, yb = torch.from_numpy(xb), torch.from_numpy(yb)
            check_regression_cpu_vs_card(device, card, xb, yb)
            for kind, flags in REG_KINDS.items():
                log.clear()
                t0 = time.perf_counter()
                model = train_regression.main(
                    flags + ["--seed=1", f"--stop_epoch={REG_EPOCHS}"])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                losses = [float(loss) for _, loss in log]
                if len(losses) != REG_EPOCHS or not all(
                        math.isfinite(v) for v in losses):
                    raise AssertionError(f"{kind}: losses {losses}")
                blob = torch.load(os.path.join(
                    regression_checkpoint_dir(
                        parse_args_regression("train_regression", flags)),
                    "best_model.tar"), weights_only=True)
                parts = ({"feature_extractor", "model"} if kind == "transfer"
                         else {"gp", "likelihood", "net"})
                if set(blob) != parts | {"epoch"}:
                    raise AssertionError(f"{kind}: checkpoint {set(blob)}")
                if kind == "transfer":  # the CLI adapts from a fresh Adam
                    model.reset_optimizer()
                own = test_regression.evaluate(model, 1, 5, REG_TEST_EPOCHS)
                t0 = time.perf_counter()
                mse = test_regression.main(
                    flags + ["--seed=1", "--n_support=5",
                             f"--n_test_epochs={REG_TEST_EPOCHS}"])
                test_s = time.perf_counter() - t0
                if not math.isfinite(mse[0]) or abs(mse[0] - own[0]) > (
                        1e-5 * own[0]):
                    raise AssertionError(f"{kind}: checkpoint MSE {mse}, "
                                         f"trained model's {own}")
                epoch_s = [b - a for (a, _), (b, _) in zip(log, log[1:])]
                results[kind] = model
                print(f"regression phase: {kind}: {model.step} steps in "
                      f"{REG_EPOCHS} epochs, losses {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}; train {train_s:.2f} s (an epoch "
                      f"{statistics.median(epoch_s):.3f} s, median of the "
                      f"last {len(epoch_s)}), test {test_s:.2f} s, MSE "
                      f"{mse[0]:.4f} +- {mse[1]:.4f} (checkpoint read back: "
                      f"{own[0]:.4f}) [{card}]", flush=True)
            restore()
            xd, yd = xb.to(device), yb.to(device)
            for kind in ("DKT rbf", "DKT spectral"):
                model = results[kind]
                seq = cuda_ms(lambda: model.unbatched_train_step(xd, yd),
                              iters=5, warmup=2) / 24
                bat = cuda_ms(lambda: model.train_step(xd, yd), iters=10,
                              warmup=2)
                print(f"regression phase: {kind}: {seq:.3f} ms a per-person "
                      f"step (--task_batch=1), {bat:.3f} ms a batched "
                      f"24-person step (CUDA events) [{card}]", flush=True)
            ft = results["transfer"]
            print(f"regression phase: transfer: "
                  f"{cuda_ms(lambda: ft.train_step(xd, yd), 10, 2):.3f} ms a "
                  f"24-person step [{card}]", flush=True)
            profile_regression_epoch(results["DKT spectral"], card)
        finally:
            restore()
            os.chdir(cwd)
            qmul._DECODE_CACHE._data.clear()
            qmul._DECODE_CACHE._bytes = 0
    launches = {c.__name__: c.launches for c in counters}
    print(f"regression phase: peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; kernel launches {launches} [{card}]", flush=True)
    if any(launches.values()):
        raise AssertionError(f"the regression path launched {launches}")


def drive_sines_path(device, card: str) -> None:
    """The sines scripts through `main`, cut in depth: train_DKT (MLP2,
    spectral 4 x 40) for 500 iterations with a 250-task eval, train_FT
    for 500 iterations with a 50-task eval (100 finetune steps a task),
    train_MAML for 100 meta-steps with a 50-task eval (half the depth of
    PRs 8-10, to keep the script near half its time limit). Prints ms a step
    (host clock between steps, each of which synchronises) and the MSEs;
    no kernel of the port may launch."""
    from deep_kernel_transfer_tpu_torch.methods import (DKTRegression,
                                                        FeatureTransfer)
    from deep_kernel_transfer_tpu_torch.sines import train_DKT, train_FT, train_MAML

    counters = kernel_counters()
    for c in counters:
        c.launches = 0
    runs = {"train_DKT": (train_DKT, ["--iterations=500",
                                      "--n_test_tasks=250"]),
            "train_FT": (train_FT, ["--iterations=500",
                                    "--n_test_tasks=50"]),
            "train_MAML": (train_MAML, ["--iterations=100",
                                        "--n_test_tasks=50"])}
    log: list = []
    restore = recording_steps([(DKTRegression, "train_step"),
                               (FeatureTransfer, "train_step"),
                               (train_MAML.SinesMAML, "meta_step")], log)
    cwd = os.getcwd()
    try:
        with tempfile.TemporaryDirectory() as root:
            os.chdir(root)
            for name, (script, args) in runs.items():
                log.clear()
                t0 = time.perf_counter()
                mses = script.main(args + ["--seed=1"])
                wall = time.perf_counter() - t0
                losses = [float(loss) for _, loss in log]
                step_ms = (log[-1][0] - log[0][0]) / (len(log) - 1) * 1e3
                if not all(math.isfinite(v) for v in losses + mses):
                    raise AssertionError(f"{name}: non-finite loss or MSE")
                print(f"sines phase: {name}: {len(log)} steps, {step_ms:.3f} "
                      f"ms a step, losses {losses[0]:.4f} -> {losses[-1]:.4f}"
                      f", MSE {np.mean(mses):.4f} +- {np.std(mses):.4f} over "
                      f"{len(mses)} tasks, {wall:.1f} s in all [{card}]",
                      flush=True)
    finally:
        restore()
        os.chdir(cwd)
    launches = {c.__name__: c.launches for c in counters}
    if any(launches.values()):
        raise AssertionError(f"the sines path launched {launches}")


# -- the study runners --------------------------------------------------------

STUDY_REPS, STUDY_ROUNDS = 2, 2  # calls a timing, turns: the cut depth
STUDY_KNEE = (8, 16)
STUDY_CLI_EPOCHS, STUDY_SWEEP_EPOCHS = 2, 2
PEAK_SIZES = {"bfloat16": (4096, 8192), "float32": (4096,)}


def drive_studies_path(device, card: str, digits_root: str | None = None
                       ) -> dict:
    """The study runners of deep_kernel_transfer_tpu_torch/benchmarks at
    full width and cut depth, each through its `main`, their rows in a
    temporary report: profile_step at B = 32, profile_resnet at profile
    batch 8 with the knee at 8 and 16, gp_probe_ab, peak_sweep at bf16
    N = 4096 and 8192 and f32 N = 4096, train_cli_e2e with 2 added epochs
    and dkt_sweep of the linear kernel, 2 epochs a run, 100 test episodes,
    in `digits_root` where given (its default runs' checkpoints stay there
    for the Laplace probe part), else in a temporary directory.
    Checks every segment finite and positive, the peak readings under the
    datasheet's rates and the fused MLL's launches, counted from 0: each
    timed call of a loss or step segment and each train step of the CLI
    runs launches it once. Returns the launches."""
    from deep_kernel_transfer_tpu_torch.benchmarks import (
        dkt_sweep, gp_probe_ab, peak_sweep, profile_resnet, profile_step,
        train_cli_e2e)
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    calls = STUDY_ROUNDS * (1 + STUDY_REPS)  # a timed fn: warm-up + reps
    timing = [f"--reps={STUDY_REPS}", f"--rounds={STUDY_ROUNDS}"]
    cli_batches = -(-train_cli_e2e.N_EPISODES // train_cli_e2e.EPISODE_BATCH)
    digits_batches = 100  # --n_train_episodes' default at one episode a batch
    runs = [
        (profile_step, ["--batch=32"] + timing, 3 * calls),
        (profile_resnet, ["--profile_batch=8", "--batches=" + ",".join(
            map(str, STUDY_KNEE))] + timing, (3 + len(STUDY_KNEE)) * calls),
        (gp_probe_ab, [], 0),
        (peak_sweep, [f"--{flag}_sizes=" + ",".join(map(str, PEAK_SIZES[t]))
                      for flag, t in (("bf16", "bfloat16"),
                                      ("f32", "float32"))], 0),
        (train_cli_e2e, [f"--epochs={STUDY_CLI_EPOCHS}"],
         (3 + STUDY_CLI_EPOCHS) * cli_batches),
        # the default bncossim run at 1 and 5 shots, then the linear kernel
        (dkt_sweep, ["--kernels=linear", f"--epochs={STUDY_SWEEP_EPOCHS}",
                     "--n_iter=100", "--repeat=1"],
         3 * STUDY_SWEEP_EPOCHS * digits_batches)]
    rows, wall = {}, {}
    fused_linear_mll.launches = 0
    with tempfile.TemporaryDirectory() as root:
        report = os.path.join(root, "studies.json")
        runs[-1][1].append(f"--root={digits_root or os.path.join(root, 'd')}")
        for runner, argv, launches in runs:
            name = runner.__name__.split(".")[-1]
            before = fused_linear_mll.launches
            t0 = time.perf_counter()
            rows.update(runner.main(argv + [f"--report={report}"]))
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            launched = fused_linear_mll.launches - before
            print(f"studies phase: {name} {' '.join(argv)}: {wall[name]:.1f} "
                  f"s, fused_linear_mll launches {launched} (want "
                  f"{launches}) [{card}]", flush=True)
            if launched != launches:
                raise AssertionError(f"{name} launched the fused MLL "
                                     f"{launched} times, want {launches}")
            torch.cuda.empty_cache()
    segments = {k: v for k, v in rows.items() if k.endswith("_ms")
                and ("_profile_b" in k or k.startswith(("profile_b",
                                                        "gp_probe_ab_tail")))
                and not k.endswith(("gp_share_ms", "opt_overhead_ms"))}
    bad = {k: v for k, v in segments.items()
           if not (math.isfinite(v) and v > 0)}
    if len(segments) != 2 * 6 + 2 or bad:
        raise AssertionError(f"segments not finite and positive: {bad} of "
                             f"{sorted(segments)}")
    for dtype, sizes in PEAK_SIZES.items():
        for n in sizes:
            rate = rows[f"gpu_peak_{dtype}_{n}_tflops"]
            if not 0 < rate <= peak_sweep.DATASHEET_TFLOPS[dtype]:
                raise AssertionError(f"{dtype} N={n}: {rate} TFLOP/s")
    knee = [rows[f"resnet10_{profile_resnet.HW}_knee_b{b}_eps_per_sec"]
            for b in STUDY_KNEE]
    if not all(isinstance(v, float) and v > 0 for v in knee):
        raise AssertionError(f"the knee: {knee}")
    acc = [v for k, v in rows.items() if k.startswith("digits_real_dkt_")
           and k.endswith("_acc")]
    if len(acc) < 5 or not all(35.0 < v <= 100.0 for v in acc):
        raise AssertionError(f"the sweep's accuracies: {acc}")
    total = fused_linear_mll.launches
    print(f"studies phase: {sum(wall.values()):.1f} s in all, fused_linear_mll"
          f" launches {total} [{card}]", flush=True)
    return {"fused_linear_mll": total}


PROBE_EPISODES = 20  # a shot: the cut depth of the Laplace probe part


def drive_laplace_probe_path(device, card: str, digits_root: str) -> dict:
    """The Laplace probe (benchmarks/laplace_probe.py) through its `main`
    at cut depth: PROBE_EPISODES novel episodes at 1 and 5 shots on the
    default runs' checkpoints that the studies phase's sweep leaves in
    digits_root, so nothing is trained here. Prints the three arms and the
    Gram's off-diagonal; checks the 14 shot rows and the protocol row
    under the JAX key names, each arm above 35%, arm (b) fitted in float64
    with scikit-learn not loaded, and no kernel launched (the probe's heads
    are the plain GP and the Laplace Newton loop). Returns the launches."""
    from deep_kernel_transfer_tpu_torch.benchmarks import laplace_probe
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import fused_linear_mll

    fused_linear_mll.launches = 0
    t0 = time.perf_counter()
    rows = laplace_probe.main(
        [f"--episodes={PROBE_EPISODES}", "--shots=1,5",
         f"--root={digits_root}",
         f"--report={os.path.join(digits_root, 'probe.json')}"], device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = fused_linear_mll.launches
    keys = set(laplace_probe.JAX_ROWS) | {"digits_real_laplace_probe_protocol"}
    missing = keys - set(rows)
    accs = {k: v for k, v in rows.items() if k.endswith("_acc")}
    for shot in (1, 5):
        pre = f"digits_real_laplace_probe_{shot}shot"
        print(f"laplace probe part: {shot}-shot over {PROBE_EPISODES} "
              f"episodes: ours {rows[pre + '_ours_acc']}% | sklearn copy "
              f"{rows[pre + '_sklearn_acc']}% | learned GP "
              f"{rows[pre + '_gp_acc']}% | offdiag "
              f"{rows[pre + '_gram_offdiag']:.3e} [{card}]", flush=True)
    float64 = all(rows[f"digits_real_laplace_probe_{s}shot_sklearn_float64"]
                  for s in (1, 5))
    sklearn_loaded = "sklearn" in sys.modules
    print(f"laplace probe part: {wall:.1f} s, arm (b) float64 {float64}, "
          f"sklearn loaded {sklearn_loaded}, fused_linear_mll launches "
          f"{launched} [{card}]", flush=True)
    if missing or len(accs) != 6 or not all(35.0 < v <= 100.0
                                            for v in accs.values()):
        raise AssertionError(f"the probe's rows: missing {sorted(missing)}, "
                             f"accuracies {accs}")
    if not float64 or sklearn_loaded or launched:
        raise AssertionError("arm (b) not the float64 copy, scikit-learn "
                             "loaded or a kernel launched")
    return {"fused_linear_mll": launched}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. the card
    from deep_kernel_transfer_tpu_torch._device import card_line

    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build every kernel
    from deep_kernel_transfer_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all(["fused_mll", "blocked_cholesky", "hbm_cholesky",
                             "episodic_batchnorm", "window_attention"])
    print(f"built {', '.join(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, log) in built.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    # 3. the fused MLL's forward and backward, and one call of each
    # Cholesky kernel, under torch.profiler
    solves = [name for name in profile_fused_mll(device)
              if "triangular" in name.lower() or "trsm" in name.lower()]
    if solves:
        raise AssertionError(f"the fused MLL's backward solves: {solves}")
    profile_cholesky(device)

    # 4. kernels against their plain versions
    kernels = {"fused_linear_mll": check_fused_mll(device)}
    check_ragged_shape(device)
    check_fused_mll_per_episode(device)
    for check_kernel in (check_blocked_cholesky, check_hbm_cholesky,
                         check_fused_gram_cholesky,
                         check_fused_gram_cholesky_tiled):
        entry = check_kernel(device)
        kernels[entry["name"]] = entry
    torch.cuda.empty_cache()
    kernels["episodic_batchnorm"] = check_episodic_batchnorm(device)
    torch.cuda.empty_cache()
    kernels["episodic_batchnorm_eval"] = check_episodic_batchnorm_eval(device)
    torch.cuda.empty_cache()
    kernels["episodic_batchnorm_eval_pool"] = \
        check_episodic_batchnorm_eval_pool(device)
    torch.cuda.empty_cache()
    kernels["window_attention"] = check_window_attention(device)
    torch.cuda.empty_cache()

    # 5. the main paths: DKT meta-training, the GP memory regime, the CLIs,
    # the test-time heads on the digits, ResNet10, ResNet50, the parallel
    # paths, the study runners and the Laplace probe on the studies'
    # digits checkpoints; then the exact GP's Woodbury route.
    # A kernel's launches are summed over the paths, each counted from 0.
    launches, step_ms = drive_main_path(device, card)
    digits = tempfile.TemporaryDirectory()
    paths = [lambda: drive_gp_memory_path(device),
             lambda: drive_cli_path(device, card, step_ms),
             lambda: drive_heads_path(device, card),
             lambda: drive_resnet_path(device, card),
             lambda: drive_resnet50_path(device, card),
             lambda: drive_swint_path(device, card),
             lambda: drive_parallel_path(device, card),
             lambda: drive_studies_path(device, card, digits.name),
             lambda: drive_laplace_probe_path(device, card, digits.name)]
    for path in paths:
        torch.cuda.empty_cache()
        for name, count in path().items():
            launches[name] = launches.get(name, 0) + count
    digits.cleanup()
    drive_woodbury_path(device, card)
    torch.cuda.empty_cache()
    drive_woodbury_cli_path(device, card)
    torch.cuda.empty_cache()
    drive_zoo_path(device, card)
    torch.cuda.empty_cache()
    drive_regression_path(device, card)
    drive_sines_path(device, card)
    for name, entry in kernels.items():
        entry["launches"] = launches[name]

    print(card, flush=True)
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
