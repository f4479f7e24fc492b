"""What the per-layer metric files (metrics/<metric>.py) read from a traced
window's record (trace.Record). Each returns None where the window holds
nothing to read, never 0."""
from __future__ import annotations

from dkt_bench import flops


def mfu(r, mode: str):
    """The model FLOPs of the traced steps (train) or protocols (eval),
    flops.py's count, over the traced window at the card's dense bf16
    peak, in percent."""
    if r.mode != mode or r.window_s <= 0:
        return None
    per = (flops.train_step_flops(r.cfg, r.traffic) if mode == "train"
           else flops.protocol_flops(r.cfg, r.traffic))
    return 100.0 * per * r.units / (r.window_s * flops.PEAK_BF16_FLOPS)


def fused_mll_roofline(r, kernels):
    """The fused MLL forward's bound at the step's shapes over the device
    time a step of the kernels whose names `kernels` (a compiled pattern)
    finds, in percent."""
    if r.mode != "train":
        return None
    t = sum(s for name, s, _ in r.kernels if kernels.search(name))
    if t <= 0:
        return None
    tr = r.traffic
    bound = flops.fused_mll_bound_s(tr["episode_batch"],
                                    flops.episode_points(tr),
                                    flops.feat_dim(r.cfg), tr["n_way"])
    return 100.0 * bound * r.units / t


def data_share(r):
    """Device time of the kernels launched inside the feed's chunk
    (make_fused_epoch) but outside the harness's train_step span, i.e. the
    episode sampling and augmentation, over the busy time, in percent."""
    if r.mode != "train" or r.busy_s <= 0:
        return None
    data = sum(s for _, s, spans in r.kernels
               if "chunk" in spans and "train_step" not in spans)
    return 100.0 * data / r.busy_s


def idle_share(r, mode: str):
    """The share of the traced window in which no operation ran on the
    card, 1 - busy / window, in percent."""
    if r.mode != mode or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
