"""The card's attainable matmul rate, bf16 and f32.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.peak_sweep

Port of JAX benchmarks/peak_sweep.py:34-84. A chain of K = 32 dependent
products y <- (y @ B) / sqrt(N) of N x N matrices, swept over N until the
rate saturates: bf16 at N in {2048, 4096, 8192, 12288, 16384}, f32 at
{2048, 4096, 8192}. Each chain is captured as one CUDA graph, the
counterpart of the JAX script's single scan dispatch: the graph's replays
carry y on (y is copied back into the graph's input at its end), and CUDA
events time `reps` replays, median of `--rounds` turns. B is scaled by
1/sqrt(N) once, so the chain runs nothing but the K products.

This sweep measures the library's rate (torch.matmul, cuBLAS) and ports
no kernel. f32 runs with TF32 off, torch's default and the GP engine's
rule, so its rows are true-f32 products; the JAX f32 rows are
DEFAULT-precision dots, bf16 passes on the TPU's matrix unit, not the
same arithmetic. A reading above the H100 SXM datasheet's dense rate
(989 TFLOP/s bf16, 67 TFLOP/s f32) means the timing is wrong, and the
run fails.

Rows gpu_peak_{dtype}_{N}_tflops and gpu_peak_attainable_bf16_tflops (the
JAX key names with tpu_ as gpu_) go to --report (studies_report.json
beside this file) with the card's name and power limit. Runs on CUDA;
`main(argv, device="cpu")` runs the chain eagerly on the CPU, timed by
the host clock.
"""
from __future__ import annotations

import argparse
import os

import torch

from ._timing import card_of, merge_report, ms_in_turns
from .profile_step import REPORT

K_CHAIN = 32
DATASHEET_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}  # H100 SXM, dense


def chain(y: torch.Tensor, b_scaled: torch.Tensor, k: int) -> torch.Tensor:
    """y after k steps y <- y @ b_scaled."""
    for _ in range(k):
        y = torch.matmul(y, b_scaled)
    return y


def tflops(n: int, k: int, reps: int, ms: float) -> float:
    """TFLOP/s of reps chains of k N x N products (2 N^3 each) in ms."""
    return 2.0 * n ** 3 * k * reps / (ms * 1e-3) / 1e12


def chain_call(n: int, dtype: torch.dtype, k: int, device):
    """fn() running one chain of k products and carrying y on: a replay of
    its CUDA graph on a CUDA device, an eager chain otherwise."""
    gen = torch.Generator(device=device).manual_seed(0)
    y = torch.randn((n, n), generator=gen, device=device).to(dtype)
    b = (torch.randn((n, n), generator=gen, device=device)
         / n ** 0.5).to(dtype)
    if device.type != "cuda":
        return lambda: y.copy_(chain(y, b, k))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm cuBLAS up outside the capture
        y.copy_(chain(y, b, k))
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y.copy_(chain(y, b, k))

    def replay():
        graph.replay()
        return y, b  # the graph reads and writes them: keep them alive

    return replay


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16_sizes", default="2048,4096,8192,12288,16384")
    ap.add_argument("--f32_sizes", default="2048,4096,8192")
    ap.add_argument("--chain", type=int, default=K_CHAIN)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..gp.kernels import full_f32

    device = resolve_device(device)
    rows = {}
    for dtype, sizes in ((torch.bfloat16, args.bf16_sizes),
                         (torch.float32, args.f32_sizes)):
        name = str(dtype).split(".")[-1]
        for n in (int(s) for s in sizes.split(",") if s):
            # at least 2 TFLOP a timing on the card (the JAX script's
            # budget); one chain on the CPU, which only rehearses
            flop = 2e12 if device.type == "cuda" else 0.0
            reps = max(1, int(flop / (2.0 * n ** 3 * args.chain)))
            with full_f32():
                fn = chain_call(n, dtype, args.chain, device)
                ms = ms_in_turns({"chain": fn}, device, args.rounds,
                                 reps)["chain"][0]
            rate = tflops(n, args.chain, 1, ms)
            rows[f"gpu_peak_{name}_{n}_tflops"] = rate
            print(f"{name} {n}x{n}: {rate:.2f} TFLOP/s ({reps} replays a "
                  f"timing, {ms:.3f} ms a chain)", flush=True)
            if device.type == "cuda" and rate > DATASHEET_TFLOPS[name]:
                raise AssertionError(
                    f"{name} at N={n}: {rate:.1f} TFLOP/s is above the "
                    f"datasheet's {DATASHEET_TFLOPS[name]}: the timing is "
                    f"wrong")
            del fn
    bf16 = [v for k, v in rows.items() if "bfloat16" in k]
    if bf16:
        rows["gpu_peak_attainable_bf16_tflops"] = max(bf16)
    rows["gpu_peak_card"] = card_of(device)
    rows["gpu_peak_protocol"] = (
        f"deep_kernel_transfer_tpu_torch.benchmarks.peak_sweep: a CUDA graph"
        f" of {args.chain} dependent NxN torch.matmul products (y <- y @ "
        f"B/sqrt(N)) carrying y across replays, replays between CUDA events,"
        f" median of {args.rounds} turns; attainable = max over the bf16 "
        f"sizes; f32 with TF32 off (true f32); H100 SXM datasheet dense "
        f"rates 989 (bf16) and 67 (f32 outside the tensor cores) TFLOP/s")
    merge_report(os.path.abspath(args.report), rows)
    return rows


if __name__ == "__main__":
    main()
