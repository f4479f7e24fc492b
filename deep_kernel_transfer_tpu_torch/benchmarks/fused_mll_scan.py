"""Device time of the fused GP-MLL's two kernels over a grid of shapes.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.fused_mll_scan

`csrc/fused_mll.cu` runs a Gram kernel (one CTA an episode and D-share)
and an episode kernel (one CTA a (way, episode): factor, inverse,
products). For each shape (B episodes, N points, D features, W ways) the
scan runs one forward of `ops/fused_mll.py` on unit-norm random features
after a warm-up, three times under torch.profiler, and prints the least
device µs of each kernel as a JSON line: around the main path's shape
(B=32, N=100, D=1600, W=5) it moves D (the Gram's depth), B and W (the
number of CTAs against the 132 SMs) and N (the factor's size). The card's
name and power limit come first. Needs a CUDA device; writes no file.
"""
from __future__ import annotations

import json

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .._device import card_line, resolve_device
from ..ops import fused_mll

SHAPES = ([(32, 100, d, 5) for d in (32, 224, 800, 1600, 3200)]
          + [(b, 100, 1600, w) for b, w in ((1, 1), (8, 5), (16, 5), (32, 4),
                                            (64, 5))]
          + [(32, n, 1600, 5) for n in (32, 64, 96, 128)])


def kernel_us(b: int, n: int, d: int, w: int, device) -> dict:
    """Least device µs of each kernel of one forward, over three runs."""
    rng = np.random.RandomState(n)
    z = rng.randn(b, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    diffs = np.where(np.arange(n)[None, :] % w == np.arange(w)[:, None],
                     1.0, -1.0).astype(np.float32)
    args = [torch.from_numpy(a).to(device) for a in
            (z, diffs, np.linspace(0.4, 1.5, w).astype(np.float32))]
    fused_mll.fused_linear_mll(*args, n, 0.1)
    torch.cuda.synchronize()
    us = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fused_mll.fused_linear_mll(*args, n, 0.1)
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = "gram" if "gram_kernel" in e.name else "episode"
                us[name] = min(us.get(name, float("inf")),
                               e.time_range.elapsed_us())
    return us


def main() -> int:
    device = resolve_device()
    print(card_line(), flush=True)
    for b, n, d, w in SHAPES:
        print(json.dumps({"B": b, "N": n, "D": d, "W": w,
                          **kernel_us(b, n, d, w, device)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
