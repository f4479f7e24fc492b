"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name, power limit) and the torch/CUDA versions.
2. Builds every CUDA kernel of the port from `csrc/` with nvcc.
3. Holds each kernel against its plain torch version on the card at the
   main path's shapes, and times kernel, plain version and the stock
   library composite with CUDA events, in turns.
4. Drives the main path: DKT meta-training (Conv4, bncossim, 5-way 5-shot
   15-query, 84x84x3 uint8 episodes, 32 episodes a step, bf16 trunk) for a
   few steps through the fused-MLL kernel, checks the losses, the kernel's
   launch count and the fused route against the plain route, runs the
   eval head, times a train step on both GP routes in turns and prints a
   torch.profiler table of the step's device time by kernel.
5. Prints one JSON line of kernel results, then as its last line
   {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no last
line. It needs a CUDA device and the package beside it; it imports nothing
of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM datasheet peaks (dense), used for each kernel's bound
PEAK_F32_FLOPS = 67e12
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


def ms_in_turns(fns: dict, rounds: int = 5, iters: int = 20) -> dict:
    """name -> (median, min, max) ms per call over `rounds` timings of each
    fn, taken in turns (a, b, c, c, b, a, ...) so that a drift of clocks or
    power between them falls on every fn alike."""
    samples = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            samples[name].append(cuda_ms(fns[name], iters))
    return {name: (statistics.median(v), min(v), max(v))
            for name, v in samples.items()}


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-8))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def mll_inputs(b: int, n: int, d: int, w: int, device):
    """bncossim-like unit-norm features and one-vs-rest diffs offset by a
    non-zero constant mean."""
    rng = np.random.RandomState(n)
    z = rng.randn(b, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    labels = np.arange(n) % w
    diffs = np.where(labels[None, :] == np.arange(w)[:, None], 1.0, -1.0)
    diffs = (diffs - 0.13).astype(np.float32)
    scales = np.linspace(0.4, 1.5, w).astype(np.float32)
    return (torch.from_numpy(z).to(device), torch.from_numpy(diffs).to(device),
            torch.from_numpy(scales).to(device))


def library_mll(z, diffs, scales, noise):
    """The same MLL from stock torch calls (cuBLAS matmul, cuSOLVER
    Cholesky, cholesky_solve): the yardstick, never used by the port."""
    n = z.shape[1]
    g = torch.matmul(z, z.transpose(-1, -2))
    k = scales[:, None, None] * g[:, None] + (noise + 1e-6) * torch.eye(
        n, device=z.device)
    chol = torch.linalg.cholesky(k)
    rhs = diffs[None, :, :, None].expand(z.shape[0], -1, -1, -1)
    alpha = torch.cholesky_solve(rhs, chol)
    quad = (rhs * alpha).sum((-1, -2))
    logdet = 2 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (quad + logdet + n * math.log(2 * math.pi)) / n


def fused_mll_bound_ms(b: int, n: int, d: int, w: int) -> tuple[float, str]:
    """Least time on an H100 SXM: the Gram's lower triangle with its
    diagonal (B·N(N+1)·D; G is symmetric and the Cholesky reads no more)
    + Cholesky (N³/3) + two solves (2N²) per (episode, way) in f32; Z,
    diffs, scales read once, mll, L and alpha written once."""
    flops = 1.0 * b * n * (n + 1) * d + b * w * (n ** 3 / 3.0 + 2.0 * n * n)
    nbytes = 4.0 * (b * n * d + w * n + w + b * w + b * w * n * n + b * w * n)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_ragged_shape(device) -> None:
    """A shape off every tile: N = 30, D = 97 (not a multiple of the
    kernel's 32-wide chunks), W = 3."""
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import (
        fused_linear_mll, fused_linear_mll_plain)

    z, diffs, scales = mll_inputs(3, 30, 97, 3, device)
    err = float((fused_linear_mll(z, diffs, scales, 30, NOISE)
                 - fused_linear_mll_plain(z, diffs, scales, 30, NOISE)
                 ).abs().max())
    print(f"fused_mll B=3 N=30 D=97 W=3: forward max abs err {err:.3e}",
          flush=True)
    if not err < 1e-5:
        raise AssertionError("fused_mll disagrees with plain at D=97")


def check_fused_mll(device) -> dict:
    """Kernel against plain version at N in {85, 100, 128}; timings at the
    main path's N = 100. Returns the kernel's JSON entry (launches filled
    in by the main path)."""
    from deep_kernel_transfer_tpu_torch.ops.fused_mll import (
        fused_linear_mll, fused_linear_mll_plain)

    entry = None
    for n in (85, 100, 128):
        z, diffs, scales = mll_inputs(MAIN_B, n, MAIN_D, MAIN_WAY, device)
        before = fused_linear_mll.launches
        got = fused_linear_mll(z, diffs, scales, n, NOISE)
        torch.cuda.synchronize()
        if fused_linear_mll.launches != before + 1:
            raise AssertionError("fused_linear_mll did not launch its kernel")
        want = fused_linear_mll_plain(z, diffs, scales, n, NOISE)
        fwd_err = float((got - want).abs().max())
        grads = []
        for fn in (fused_linear_mll, fused_linear_mll_plain):
            args = [t.clone().requires_grad_(True) for t in (z, diffs, scales)]
            loss = -fn(*args, n, NOISE).sum()
            grads.append(torch.autograd.grad(loss, args))
        grad_errs = [rel_err(a, b) for a, b in zip(*grads)]
        print(f"fused_mll N={n}: forward max abs err {fwd_err:.3e}, grad rel "
              f"err dz {grad_errs[0]:.3e} ddiffs {grad_errs[1]:.3e} dscales "
              f"{grad_errs[2]:.3e}", flush=True)
        if not (fwd_err < 1e-5 and max(grad_errs) < 2e-2):
            raise AssertionError(f"fused_mll disagrees with plain at N={n}")
        if n == 100:
            times = ms_in_turns({
                "kernel": lambda: fused_linear_mll(z, diffs, scales, n, NOISE),
                "plain": lambda: fused_linear_mll_plain(z, diffs, scales, n,
                                                        NOISE),
                "library": lambda: library_mll(z, diffs, scales, NOISE)})
            ms, plain_ms, library_ms = (times[k][0] for k in
                                        ("kernel", "plain", "library"))
            bound_ms, bound_by = fused_mll_bound_ms(MAIN_B, n, MAIN_D, MAIN_WAY)
            entry = {
                "name": "fused_linear_mll",
                "route": "cuda",
                "source": "deep_kernel_transfer_tpu_torch/csrc/fused_mll.cu",
                "replaces":
                    "deep_kernel_transfer_tpu/ops/pallas/fused_mll.py:165",
                "launches": None,
                "max_abs_err": fwd_err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library_ms,
            }
            print(f"fused_mll B={MAIN_B} N={n} D={MAIN_D} W={MAIN_WAY}, "
                  f"median (min-max) of 5 turns: " + ", ".join(
                      f"{k} {v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f}) ms"
                      for k, v in times.items())
                  + f", bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return entry


def drive_main_path(device, card: str) -> dict:
    """5 DKT meta-training steps at full width through the fused kernel.
    Returns each kernel's launch count over those steps."""
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
    losses = [model.train_step(batches[i % 2])["loss"] for i in range(5)]
    torch.cuda.synchronize()
    launches = {"fused_linear_mll": fused_linear_mll.launches}
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

    acc = model.batch_correct(batches[1])
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
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    # 1. the card
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build every kernel
    from deep_kernel_transfer_tpu_torch.ops import build

    t0 = time.perf_counter()
    _, log = build.build("fused_mll")
    print(f"built fused_mll in {time.perf_counter() - t0:.1f} s\n"
          f"nvcc fused_mll:\n{log.strip()}", flush=True)

    # 3. kernels against their plain versions
    kernels = {"fused_linear_mll": check_fused_mll(device)}
    check_ragged_shape(device)

    # 4. the main path
    launches = drive_main_path(device, card)
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
