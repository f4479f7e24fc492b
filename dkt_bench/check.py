"""The numbers that decide `correct`, each held to its cell's limit
(limits/<cell>.json).

Training (the first three steps of the run, which set-up drives through
the window's own feed and step, against the reference's three steps from
the same weights and seed):
  * input_mean_diff: the mean absolute difference, in uint8 units, of the
    program's augmented episode batches from the reference's (the largest
    difference is reported beside it: a resampled value that lies at a
    rounding boundary flips by 1 on some seeds);
  * loss_gap: the largest relative gap of a step's loss (each step's gap
    is reported beside it);
  * loss_gap_step1: the relative gap of the first step's loss, before any
    update: steady from seed to seed where the later steps amplify
    round-off (ResNet10, PERF.md);
  * grad_gap: the first gradient, as the program's Adam holds it after one
    step (exp_avg / (1 - beta1)), against the reference's, by the worst
    leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's;
  * change_gap: the gap of the norms of each parameter's change over the
    three steps, as above, by the worst leaf that a step moves: leaves
    whose float64 gradient (reference.dkt.exact_grad, on the first
    episodes of the first batch) is under a thousandth of the median
    leaf's are left out. Such a leaf, a conv bias under a training-mode
    BatchNorm, has a gradient of round-off alone in bfloat16, which Adam
    moves by about its rate whatever its size (the leaves left out are
    reported beside it);
  * bn_gap: the same of the change of each BatchNorm running average, by
    the worst running average.
Eval (sampled batches of the window's protocols):
  * post_mean_gap: the largest absolute gap of a posterior mean at a
    query, against the reference's.
A number that cannot be read (a shape that differs, a batch that never
came, a value that is not finite) is infinite.
"""
from __future__ import annotations

import math
import statistics

import torch

INF = float("inf")


def _norms(tree: dict, names) -> dict:
    return {n: float(tree[n].double().norm()) for n in names}


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """{leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's} over `names`; a leaf the
    program lacks, or of another shape, gives INF."""
    names = list(names)
    for n in names:
        if prog.get(n) is None or prog[n].shape != ref[n].shape:
            return {n: INF}
    p, r = _norms(prog, names), _norms(ref, names)
    med = statistics.median(r.values()) if names else 0.0
    return {n: _finite(abs(p[n] - r[n]) / max(r[n], med, 1e-30))
            for n in names}


def leaf_gap(prog: dict, ref: dict, names) -> tuple[float, str]:
    """(worst gap of norms, its leaf) over `names`."""
    gaps = leaf_gaps(prog, ref, names)
    return max(((g, n) for n, g in gaps.items()), default=(0.0, ""))


def _finite(x: float) -> float:
    return x if math.isfinite(x) else INF


def train_numbers(prog: dict, ref: dict, params0: dict,
                  trainable: list[str]) -> tuple[dict, dict]:
    """(numbers, the worst leaf of each) of the program's snapshot
    against the reference's, both as reference.dkt.train_steps returns
    them."""
    nums, where = {}, {}
    if len(prog["inputs"]) != len(ref["inputs"]) or any(
            a.shape != b.shape for a, b in zip(prog["inputs"], ref["inputs"])):
        nums["input_mean_diff"] = INF
    else:
        diffs = [(a.to(torch.int16) - b.to(torch.int16)).abs()
                 for a, b in zip(prog["inputs"], ref["inputs"])]
        nums["input_mean_diff"] = float(
            sum(d.double().sum() for d in diffs)
            / sum(d.numel() for d in diffs))
        where["input_mean_diff"] = (
            f"largest difference {max(int(d.max()) for d in diffs)}")
    if len(prog["losses"]) != len(ref["losses"]):
        nums["loss_gap"] = nums["loss_gap_step1"] = INF
    else:
        steps = [_finite(abs(a - b) / max(abs(b), 1e-30))
                 for a, b in zip(prog["losses"], ref["losses"])]
        nums["loss_gap"], nums["loss_gap_step1"] = max(steps), steps[0]
        where["loss_gap"] = "steps " + ", ".join(f"{g:.3g}" for g in steps)
    nums["grad_gap"], where["grad_gap"] = leaf_gap(prog["grad1"], ref["grad1"],
                                                   trainable)
    g = _norms(ref["grad_exact"], trainable)
    med = statistics.median(g.values())
    moved = [n for n in trainable if g[n] >= 1e-3 * med]
    running = [n for n in params0 if n not in trainable]

    def change(snap):
        return {n: snap["params"][n] - params0[n] for n in params0}

    dp, dr = change(prog), change(ref)
    nums["change_gap"], leaf = leaf_gap(dp, dr, moved)
    where["change_gap"] = (f"worst leaf {leaf}; {len(trainable) - len(moved)}"
                           f" of {len(trainable)} leaves left out")
    nums["bn_gap"], where["bn_gap"] = leaf_gap(dp, dr, running)
    return nums, where


def eval_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """post_mean_gap over the batches `ref` holds ({key: means})."""
    worst, at = 0.0, ""
    for key, r in ref.items():
        p = prog.get(key)
        if p is None or p.shape != r.shape:
            return {"post_mean_gap": INF}, {"post_mean_gap": f"{key} missing"}
        g = float((p.double() - r.double()).abs().max())
        if not math.isfinite(g):
            return {"post_mean_gap": INF}, {"post_mean_gap": str(key)}
        if g >= worst:
            worst, at = g, str(key)
    return {"post_mean_gap": worst}, {"post_mean_gap": at}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit within it, {name: {value, limit}}).
    A number that the cell's limits leave out is read but not compared:
    it had no upper reading (see PERF.md)."""
    checks = {n: {"value": nums[n], "limit": lim} for n, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
