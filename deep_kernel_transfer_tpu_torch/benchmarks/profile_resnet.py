"""Segment profile and episode-batch knee of DKT on ResNet10 at 224 px.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.profile_resnet \\
        --profile_batch 16 --batches 8,16,24,32

Port of JAX benchmarks/profile_resnet.py:106-170. DKT(ResNet10,
bncossim), 5-way 5-shot 15-query episodes of 224x224x3 uint8 images,
bf16 trunk, the fused-MLL route:

  * the segments of profile_step.segments at --profile_batch episodes,
    rows `resnet10_224_profile_b{B}_*` (the JAX rows trunk_fwd,
    trunk_fwd_bwd, loss_fwd_bwd, train_step and gp_share, and the others
    of profile_step beside them);
  * the knee: the train step's episodes a second at each batch of
    --batches, rows `resnet10_224_knee_b{b}_eps_per_sec`, each merged into
    the report as soon as it is measured. A batch that does not fit the
    card's memory (torch.cuda.OutOfMemoryError) is written "oom", the
    allocator's cache is freed and the knee goes on; any other error
    propagates (the JAX script writes "error:<class>" for every
    exception, profile_resnet.py:162-167).

Rows go to --report (studies_report.json beside this file) with the
card's name and power limit. Runs on CUDA; `main(argv, device="cpu")`
runs on the CPU.
"""
from __future__ import annotations

import argparse
import gc
import os

import torch

from ._timing import card_of, merge_report, ms_in_turns
from .profile_step import REPORT, build_dkt, episodes, profile

HW = 224


def step_eps_per_sec(model, b: int, px: int, device, reps: int,
                     rounds: int) -> float:
    """Episodes a second of model.train_step on b episodes of px pixels."""
    xb = episodes(b, px, device, seed=2)
    ms = ms_in_turns({"step": lambda: model.train_step(xb)}, device,
                     rounds, reps)["step"][0]
    return b / ms * 1e3


def knee(model, batches, px: int, device, reps: int, rounds: int,
         report: str) -> dict:
    """The knee's rows, each merged into `report` once measured."""
    rows = {}
    for b in batches:
        key = f"resnet10_{px}_knee_b{b}_eps_per_sec"
        try:
            rows[key] = step_eps_per_sec(model, b, px, device, reps, rounds)
        except torch.cuda.OutOfMemoryError:
            rows[key] = "oom"
        if rows[key] == "oom":
            # outside the handler, whose traceback holds the step's tensors
            model.optimizer.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.empty_cache()
        merge_report(report, {key: rows[key]})
        print(f"{key}: {rows[key]}", flush=True)
    return rows


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="8,16,24,32")
    ap.add_argument("--profile_batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=4,
                    help="calls a timing (the JAX script's R)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..models import ResNet10

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    model = build_dkt(ResNet10(), HW, device)
    b, tag = args.profile_batch, f"resnet10_{HW}"
    prefix = f"{tag}_profile_b{b}_"
    rows = profile(model, episodes(b, HW, device, seed=2), device,
                   args.reps, args.rounds, prefix)
    rows[f"{tag}_card"] = card_of(device)
    rows[f"{tag}_protocol"] = (
        f"deep_kernel_transfer_tpu_torch.benchmarks.profile_resnet: "
        f"DKT(ResNet10, bncossim) 5w5s15q {HW} px uint8, bf16 trunk, "
        f"fused MLL; {args.reps} calls between CUDA events after a warm-up"
        f" call, median of {args.rounds} turns; knee over {args.batches}")
    merge_report(report, rows)
    for k, v in rows.items():
        print(f"{k}: {v}", flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rows.update(knee(model, [int(s) for s in args.batches.split(",")],
                     HW, device, args.reps, args.rounds, report))
    return rows


if __name__ == "__main__":
    main()
