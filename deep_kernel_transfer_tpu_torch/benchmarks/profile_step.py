"""Segment profile of the DKT meta-training step: where its time goes.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.profile_step --batch 32

Port of JAX benchmarks/profile_step.py:63-127. DKT(Conv4, bncossim),
5-way 5-shot 15-query episodes of 84x84x3 uint8 images (random, from a
seed), `--batch` episodes (bench.py's flagship is 32), bf16 trunk, the
fused-MLL route. Each segment is timed by `_timing.ms_in_turns`, the
segments taking turns:

  * trunk_fwd / trunk_fwd_eval: `DKT._features` in train mode (batch
    statistics per episode, as the step takes them) and in eval mode
    (running averages: the difference is the statistics' passes), under
    torch.no_grad, since the JAX forward keeps no residuals;
  * trunk_fwd_bwd: the gradient of sum(z**2) in the trunk's parameters;
  * loss_fwd / loss_fwd_bwd: `batch_loss_train` and its gradient in every
    parameter (trunk and fused-MLL GP tail);
  * train_step: `model.train_step` (Adam and the BatchNorm merge too);

and derived, as the JAX script derives them: gp_share = loss_fwd_bwd -
trunk_fwd_bwd, opt_overhead = train_step - loss_fwd_bwd, and the episodes
a second at train_step. Rows `profile_b{B}_*` (the JAX key names) go to
--report (studies_report.json beside this file) with the card's name and
power limit, with the fused MLL's launches over the timed calls. Runs on
CUDA; `main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os

import torch

from ._timing import card_of, merge_report, ms_in_turns

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(HERE, "studies_report.json")
N_WAY, N_SUPPORT, N_QUERY, HW = 5, 5, 15, 84
SEGMENTS = ("trunk_fwd", "trunk_fwd_eval", "trunk_fwd_bwd", "loss_fwd",
            "loss_fwd_bwd", "train_step")


def segments(model, xb: torch.Tensor) -> dict:
    """name -> a function running that segment of `model`'s train step on
    episodes xb [B, n_way, S+Q, H, W, C] (SEGMENTS order). Each returns
    what it computed: features, gradients, a loss."""
    b = xb.shape[0]
    x_flat = xb.reshape((-1,) + tuple(xb.shape[3:]))
    trunk = list(model.feature.parameters())
    every = list(model.parameters())

    def trunk_fwd():
        with torch.no_grad():
            return model._features(x_flat, train=True, ep_groups=b)[0]

    def trunk_fwd_eval():
        with torch.no_grad():
            return model._features(x_flat, train=False)[0]

    def trunk_fwd_bwd():
        z, _ = model._features(x_flat, train=True, ep_groups=b)
        return torch.autograd.grad(torch.sum(z.float() ** 2), trunk)

    def loss_fwd():
        with torch.no_grad():
            return model.batch_loss_train(xb)[0]

    def loss_fwd_bwd():
        return torch.autograd.grad(model.batch_loss_train(xb)[0], every)

    def train_step():
        return model.train_step(xb)["loss"]

    return dict(zip(SEGMENTS, (trunk_fwd, trunk_fwd_eval, trunk_fwd_bwd,
                               loss_fwd, loss_fwd_bwd, train_step)))


def derived(ms: dict, b: int) -> dict:
    """The JAX script's derived rows (profile_step.py:122-126) from the
    segments' ms."""
    return {"gp_share_ms": ms["loss_fwd_bwd_ms"] - ms["trunk_fwd_bwd_ms"],
            "opt_overhead_ms": ms["train_step_ms"] - ms["loss_fwd_bwd_ms"],
            "eps_per_sec_at_step": b / ms["train_step_ms"] * 1e3}


def profile(model, xb: torch.Tensor, device, reps: int, rounds: int,
            prefix: str) -> dict:
    """Rows `{prefix}{segment}_ms` (medians of turns), the derived rows,
    each segment's min-max, and the fused MLL's launches over the timed
    calls (it counts only where it launches its kernel: on CUDA)."""
    from ..ops.fused_mll import fused_linear_mll

    before = fused_linear_mll.launches
    times = ms_in_turns(segments(model, xb), device, rounds, reps)
    launches = fused_linear_mll.launches - before
    ms = {f"{name}_ms": t[0] for name, t in times.items()}
    rows = {**ms, **derived(ms, xb.shape[0]),
            **{f"{name}_ms_range": [t[1], t[2]] for name, t in times.items()},
            "fused_mll_launches": launches}
    return {prefix + k: v for k, v in rows.items()}


def episodes(b: int, px: int, device, seed: int = 1) -> torch.Tensor:
    """b random uint8 episodes [b, N_WAY, S+Q, px, px, 3] from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (b, N_WAY, N_SUPPORT + N_QUERY, px, px, 3),
                         generator=gen, device=device, dtype=torch.uint8)


def build_dkt(backbone, px: int, device):
    """DKT(backbone, bncossim) 5-way 5-shot, bf16 trunk, fused-MLL route,
    weights from seed 0."""
    from ..methods import DKT

    example = torch.zeros((N_WAY, N_SUPPORT + N_QUERY, px, px, 3),
                          dtype=torch.uint8)
    return DKT(backbone, N_WAY, N_SUPPORT, kernel_type="bncossim",
               device=device).init(example, torch.Generator().manual_seed(0))


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8,
                    help="calls a timing (the JAX script's R)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timings a segment, taken in turns")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..models import Conv4

    device = resolve_device(device)
    b = args.batch
    model = build_dkt(Conv4(), HW, device)
    rows = profile(model, episodes(b, HW, device), device, args.reps,
                   args.rounds, f"profile_b{b}_")
    rows[f"profile_b{b}_card"] = card_of(device)
    rows[f"profile_b{b}_protocol"] = (
        f"deep_kernel_transfer_tpu_torch.benchmarks.profile_step --batch {b}"
        f": DKT(Conv4, bncossim) 5w5s15q {HW} px uint8, bf16 trunk, fused "
        f"MLL;"
        f" each segment {args.reps} calls between CUDA events after a "
        f"warm-up call, median of {args.rounds} turns")
    merge_report(os.path.abspath(args.report), rows)
    for k, v in rows.items():
        print(f"{k}: {v}", flush=True)
    return rows


if __name__ == "__main__":
    main()
