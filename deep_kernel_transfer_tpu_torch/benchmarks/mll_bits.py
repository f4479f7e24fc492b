"""Fingerprints of the fused MLL kernel's outputs in its shared-parameter
form, to hold two checkouts of the port to the same bits on one card.

    python3 deep_kernel_transfer_tpu_torch/benchmarks/mll_bits.py \\
        [--package-root DIR]

Imports `deep_kernel_transfer_tpu_torch` from DIR (default: the checkout
holding this file), runs the kernel once on seeded inputs (bncossim-like
unit rows, one-vs-rest diffs offset by -0.13, scales [W] from 0.4 to 1.5)
at the main path's shape (B=32, N=100, D=1600, W=5) and at the digits
shape (B=32, N=25, D=64, W=5), and prints one JSON line with the SHA-256
of each output's bytes (mll, L^-1, alpha, G). Run it from two checkouts in
one call and compare the lines. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

SHAPES = ((32, 100, 1600, 5), (32, 25, 64, 5))
NOISE = 0.1


def inputs(b: int, n: int, d: int, w: int):
    rng = np.random.RandomState(n)
    z = rng.randn(b, n, d).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    labels = np.arange(n) % w
    diffs = np.where(labels[None, :] == np.arange(w)[:, None], 1.0, -1.0)
    diffs = (diffs - 0.13).astype(np.float32)
    scales = np.linspace(0.4, 1.5, w).astype(np.float32)
    return z, diffs, scales


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.package_root)
    sys.path.insert(0, root)
    import torch

    from deep_kernel_transfer_tpu_torch.ops import fused_mll as fm

    if not torch.cuda.is_available():
        raise SystemExit("mll_bits: no CUDA device")
    out = {"package_root": root}
    for b, n, d, w in SHAPES:
        z, diffs, scales = (torch.from_numpy(a).cuda()
                            for a in inputs(b, n, d, w))
        res = fm._forward_cuda(z, diffs, scales, NOISE, 1e-6)
        torch.cuda.synchronize()
        for name, t in zip(("mll", "L^-1", "alpha", "G"), res):
            out[f"B={b} N={n} D={d} W={w} {name}"] = hashlib.sha256(
                t.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
