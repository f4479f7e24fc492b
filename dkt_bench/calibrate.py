"""The readings that each limit of limits/<cell>.json is set from, at the
cell's own size on the card, in one process:

    python3 -m dkt_bench.calibrate --workload <cell> --seeds 11,12,... \\
        [--control 21,22,23] [--witness 41,42,43] \\
        [--faults half_batch,altered,unchanged,gp_lr] \\
        [--fault-seeds 31,32,33] [--seconds 2] --out <file.jsonl>

For each seed one JSON line: the numbers `correct` compares for a sound
run of the program (law "program"), for the control (the reference one
precision down in the program's place), or for the program with a fault
planted underneath the timed path:

  * unchanged: the optimizer's step leaves every parameter as it was;
  * half_batch: the loss takes half of the episode batch, its mean over
    those episodes;
  * altered: one answer altered where it is produced: one augmented image
    zeroed (training), one query's posterior means negated (eval);
  * gp_lr: Adam steps the GP's leaves at the trunk's rate (1e-3, not
    1e-4).

and, in a training cell, the witness (law "onepass"): the reference with
the program's one-pass BatchNorm variance in the program's place, float32
statistics of equal standing, which reads what round-off alone gives each
number.

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

from dkt_bench import run
from dkt_bench.registry import Registry

@contextlib.contextmanager
def planted(fault: str, mode: str):
    """The program with `fault` planted underneath the timed path."""
    import torch

    from deep_kernel_transfer_tpu_torch.data import device_aug
    from deep_kernel_transfer_tpu_torch.methods.dkt import DKT

    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    if fault == "unchanged":
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        loss = DKT.batch_loss_train
        patch(DKT, "batch_loss_train",
              lambda self, xb: loss(self, xb[:max(1, xb.shape[0] // 2)]))
    elif fault == "gp_lr":
        adam_step = torch.optim.Adam.step

        def step(self, closure=None):
            top = max(g["lr"] for g in self.param_groups)
            for g in self.param_groups:
                g["lr"] = top
            return adam_step(self, closure)

        patch(torch.optim.Adam, "step", step)
    elif fault == "altered" and mode == "train":
        aug = device_aug.apply_augment

        def altered(images, draws, out_size):
            out = aug(images, draws, out_size)
            flat = out.view((-1,) + tuple(out.shape[-3:]))
            flat[0] = 0
            return out

        patch(device_aug, "apply_augment", altered)
    elif fault == "altered":
        logits = DKT._logits_from_features

        def altered(self, *a, **k):
            out = logits(self, *a, **k)
            out[..., 0, :] = -out[..., 0, :]
            return out

        patch(DKT, "_logits_from_features", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def reading(reg, cell, seed, seconds, law="program", fault=None,
            device="cuda") -> dict:
    t = time.time()
    if fault is None:
        res, _, where, nums = run.run_cell(reg, cell, seed, seconds, False,
                                           device=device, law=law, t_start=t)
    else:
        mode = reg.traffic(reg.cell(cell)["traffic"])["mode"]
        with planted(fault, mode):
            res, _, where, nums = run.run_cell(reg, cell, seed, seconds,
                                               False, device=device, t_start=t)
    nums = {k: v if math.isfinite(v) else None for k, v in nums.items()}
    return {"cell": cell, "seed": seed, "law": law, "fault": fault,
            "numbers": nums, "worst": where, "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "device": res["device"], "seconds": time.time() - t}


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--witness", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    reg = Registry()
    jobs = ([(s, "program", None) for s in _seeds(args.seeds)]
            + [(s, "control", None) for s in _seeds(args.control)]
            + [(s, "onepass", None) for s in _seeds(args.witness)]
            + [(s, "program", f) for f in args.faults.split(",") if f
               for s in _seeds(args.fault_seeds)])
    with open(args.out, "a") as out:
        for seed, law, fault in jobs:
            line = reading(reg, args.workload, seed, args.seconds, law, fault)
            out.write(json.dumps(line) + "\n")
            out.flush()
            print(json.dumps({k: line[k] for k in
                              ("seed", "law", "fault", "numbers", "correct",
                               "seconds")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
