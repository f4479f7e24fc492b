"""The memory crossover of the fused-Gram Cholesky, on one GPU.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.hbm_memory_demo \\
        [--sizes 8192,32768,106496] [--feat_dim 256] [--timeout 900]

The counterpart of benchmarks/hbm_memory_demo.py. Workload: logdet(2 Z Z^T
+ 0.1 I), Z [1, N, D] f32 with unit-norm rows made from a seed, the MLL's
logdet term at a huge support size, by two arms:

  plain:  K = Z Z^T (torch.matmul, TF32 off), scaled and its diagonal
          raised in place; L = torch.linalg.cholesky(K); 2 sum log diag L.
          Holds two N x N buffers (K and L).
  fused:  tiled_log_det(fused_gram_cholesky_tiled(Z, 2, 0.1)), the
          hand-written kernel. Holds one N x N buffer (the tiled factor).

Each arm runs at each N in a subprocess of its own with a timeout, so that
running out of memory is a recorded outcome and not a crashed sweep. Per
arm and N it reports seconds (CUDA events around one run, after a small
warm-up run that loads the libraries), peak torch.cuda.max_memory_allocated
and the logdet; the two logdets must agree within 1e-3 relative at the
smallest N where both complete. Any failure of the fused arm, or a parity
miss, exits non-zero. Prints JSON lines; writes no file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .._device import card_line, resolve_device
from ..gp.kernels import full_f32
from ..ops.hbm_cholesky import fused_gram_cholesky_tiled, tiled_log_det

SCALE, DIAG = 2.0, 0.1
ARMS = ("plain", "fused")
REPO_ROOT = Path(__file__).resolve().parents[2]


def make_z(n: int, d: int, seed: int, device) -> torch.Tensor:
    """Z [1, N, D] f32 with unit-norm rows, from a numpy seed."""
    z = np.random.RandomState(seed).randn(1, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return torch.from_numpy(z).to(device)


def logdet_plain(z: torch.Tensor) -> torch.Tensor:
    """Assemble, then factor: two N x N buffers at the peak."""
    with full_f32():
        k = torch.matmul(z, z.mT)
    k.mul_(SCALE)
    k.diagonal(dim1=-2, dim2=-1).add_(DIAG)
    chol = torch.linalg.cholesky(k)
    return 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)


def logdet_fused(z: torch.Tensor) -> torch.Tensor:
    """The fused-Gram kernel, tile-blocked: one N x N buffer at the peak."""
    return tiled_log_det(fused_gram_cholesky_tiled(z, SCALE, DIAG))


LOGDET = {"plain": logdet_plain, "fused": logdet_fused}


def run_arm(arm: str, n: int, d: int, seed: int = 0, device=None) -> dict:
    """One arm at one N in this process: seconds, peak GiB, logdet."""
    device = resolve_device(device)
    fn = LOGDET[arm]
    fn(make_z(256, d, seed, device))  # loads cuBLAS/cuSOLVER or the kernel
    z = make_z(n, d, seed, device)
    try:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            value = fn(z)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
            peak = torch.cuda.max_memory_allocated(device) / 2**30
        else:
            t0 = time.perf_counter()
            value = fn(z)
            seconds, peak = time.perf_counter() - t0, None
    except torch.OutOfMemoryError as e:
        return {"arm": arm, "n": n, "ok": False, "error": "OOM",
                "detail": str(e).splitlines()[0][:300]}
    return {"arm": arm, "n": n, "ok": True, "logdet": float(value[0]),
            "seconds": seconds, "peak_gib": peak, "device": str(device)}


def probe(arm: str, n: int, d: int, seed: int, device, timeout: float) -> dict:
    """run_arm in a subprocess of its own."""
    cmd = [sys.executable, "-m", __spec__.name, "--probe", arm, "--sizes",
           str(n), "--feat_dim", str(d), "--seed", str(seed)]
    if device is not None:
        cmd += ["--device", str(device)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, cwd=REPO_ROOT)
    except subprocess.TimeoutExpired:
        return {"arm": arm, "n": n, "ok": False, "error": f"timeout>{timeout}s"}
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    lines = [l for l in (proc.stderr or proc.stdout).splitlines() if l.strip()]
    return {"arm": arm, "n": n, "ok": False, "error": f"rc={proc.returncode}",
            "detail": lines[-1][:300] if lines else ""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="8192,32768,106496")
    ap.add_argument("--feat_dim", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds for each arm's subprocess")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without a CUDA device)")
    ap.add_argument("--probe", choices=ARMS, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]

    if args.probe:
        result = run_arm(args.probe, sizes[0], args.feat_dim, args.seed,
                         args.device)
        print("RESULT " + json.dumps(result), flush=True)
        return 0

    device = resolve_device(args.device)
    if device.type == "cuda":
        print(json.dumps({"card": card_line(),
                          "kind": torch.cuda.get_device_name(device)}),
              flush=True)
    failed, parity = False, None
    for n in sizes:
        got = {}
        for arm in ARMS:
            r = probe(arm, n, args.feat_dim, args.seed, args.device,
                      args.timeout)
            print(json.dumps(r), flush=True)
            got[arm] = r
            failed |= arm == "fused" and not r["ok"]
        if parity is None and all(r["ok"] for r in got.values()):
            a, b = got["plain"]["logdet"], got["fused"]["logdet"]
            parity = {"n": n, "rel": abs(a - b) / max(abs(a), 1.0)}
            failed |= not parity["rel"] < 1e-3
    print(json.dumps({"protocol": f"logdet({SCALE} Z Z^T + {DIAG} I), Z [1, "
                      f"N, {args.feat_dim}] f32, one subprocess per arm",
                      "parity": parity, "ok": not failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
