"""DKT's kernel and training-budget sweep on the real digits.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.dkt_sweep \\
        --kernels rbf,matern,cossim,linear --shots 5 --epoch_sweep_shots 1,5

Port of JAX benchmarks/dkt_sweep.py:40-146, through the port's `train`
and `test` CLIs on the digits_real filelists (digits_real.
make_digits_filelists: base = val = digits 0-4, novel = 5-9; Conv4S,
5-way, seed 1), with the JAX rows' flags:

  * the budget sweep: every saved checkpoint (every --save_freq epoch and
    the last) of the default bncossim run at each shot of
    --epoch_sweep_shots, through `test --save_iter=k --repeat=1`; rows
    digits_real_dkt_5way_{S}shot_ep{k}_{acc,ci95}. The default run is
    trained first where its checkpoints are missing;
  * --early_stop_only: instead, the epoch-0 checkpoint of the default run
    through `test --repeat`; rows digits_real_dkt_earlystop_5way_{S}shot_*;
  * the kernel sweep: each kernel of --kernels trained in a working
    directory of its own (the checkpoint's name carries no kernel) with
    --kernel_type and --resume, then tested with --repeat runs; rows
    digits_real_dkt_{kernel}_5way_{S}shot_{acc,ci95,seed_std,train_s}.

--epochs (the stop epoch of every run trained here; -1 is the default),
--n_iter (test episodes a run) and --repeat cut the sweep. Rows go to
--report (digits_report.json beside this file) with the card's name and
power limit, merged after every row; --skip_existing skips a row the
report holds, so one call can run one kernel. Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np

from ._timing import card_of, merge_report
from .digits_real import REPORT, make_digits_filelists

EARLYSTOP_PROTOCOL = (
    "the default bncossim run's epoch-0 checkpoint (one meta-training "
    "epoch), full --repeat eval — the early-stop config the budget sweep "
    "shows is competitive on the 5-base-class split")


def cli(shot: int, extra: list) -> list:
    """The JAX sweep's flags (dkt_sweep.py:77-80) and `extra`."""
    return (["--dataset=omniglot", "--model=Conv4", "--train_n_way=5",
             "--test_n_way=5", f"--n_shot={shot}", "--seed=1",
             "--method=DKT"] + extra)


def checkpoint_epochs(ckdir: str) -> list:
    """The epochs saved in ckdir (<epoch>.tar), in order (dkt_sweep.py
    :97-99)."""
    if not os.path.isdir(ckdir):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(ckdir) if f[:-4].isdigit())


def default_ckdir(shot: int) -> str:
    return f"./save/checkpoints/omniglot/Conv4S_DKT_5way_{shot}shot"


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="rbf,matern,cossim,linear")
    ap.add_argument("--shots", default="5",
                    help="shots of the kernel sweep")
    ap.add_argument("--epoch_sweep_shots", default="1,5")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=-1)
    ap.add_argument("--n_iter", type=int, default=600,
                    help="test episodes a run")
    ap.add_argument("--early_stop_only", action="store_true",
                    help="only the --repeat test of the default run's "
                         "epoch-0 checkpoint")
    ap.add_argument("--skip_existing", action="store_true")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .. import test, train
    from .._device import resolve_device

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    existing = {}
    if os.path.exists(report):
        with open(report) as f:
            existing = json.load(f)
    card = card_of(device)
    merge_report(report, {"digits_real_dkt_sweep_card": card})
    rows: dict = {}

    def record(update: dict) -> None:
        rows.update(update)
        merge_report(report, update)

    def skip(key: str) -> bool:
        if args.skip_existing and f"{key}_acc" in existing:
            print(f"-- skip {key} (in the report)", flush=True)
            return True
        return False

    stop = [f"--stop_epoch={args.epochs}"] if args.epochs != -1 else []
    n_iter = [f"--n_iter={args.n_iter}"]

    def default_run(shot: int) -> None:
        if not checkpoint_epochs(default_ckdir(shot)):
            t0 = time.perf_counter()
            train.main(cli(shot, stop), device=device)
            record({f"digits_real_dkt_5way_{shot}shot_sweep_train_s":
                    time.perf_counter() - t0})

    shots = [int(s) for s in args.epoch_sweep_shots.split(",") if s]
    cwd = os.getcwd()
    workdir = (contextlib.nullcontext(args.root) if args.root
               else tempfile.TemporaryDirectory())
    with workdir as root:
        root = os.path.abspath(root)
        make_digits_filelists(root)
        os.chdir(root)
        try:
            if args.early_stop_only:
                for shot in shots:
                    key = f"digits_real_dkt_earlystop_5way_{shot}shot"
                    if skip(key):
                        continue
                    default_run(shot)
                    acc, ci, runs = test.main(
                        cli(shot, [f"--repeat={args.repeat}",
                                   "--save_iter=0"] + n_iter),
                        device=device, return_runs=True)
                    record({f"{key}_acc": acc, f"{key}_ci95": ci,
                            f"{key}_seed_std": float(np.std(runs)),
                            "digits_real_dkt_earlystop_protocol":
                                EARLYSTOP_PROTOCOL})
                    print(f"== earlystop {shot}-shot: {acc:.2f}% +- "
                          f"{ci:.2f}% [{card}]", flush=True)
                return rows
            for shot in shots:
                default_run(shot)
                for it in checkpoint_epochs(default_ckdir(shot)):
                    key = f"digits_real_dkt_5way_{shot}shot_ep{it}"
                    if skip(key):
                        continue
                    acc, ci = test.main(
                        cli(shot, ["--repeat=1", f"--save_iter={it}"]
                            + n_iter), device=device)
                    record({f"{key}_acc": acc, f"{key}_ci95": ci})
                    print(f"== epoch {it} ({shot}-shot): {acc:.2f}% +- "
                          f"{ci:.2f}% [{card}]", flush=True)
            for kernel in (k for k in args.kernels.split(",") if k):
                for shot in (int(s) for s in args.shots.split(",") if s):
                    key = f"digits_real_dkt_{kernel}_5way_{shot}shot"
                    if skip(key):
                        continue
                    wd = os.path.join(root, f"kern_{kernel}")
                    os.makedirs(wd, exist_ok=True)
                    link = os.path.join(wd, "filelists")
                    if not os.path.exists(link):
                        os.symlink(os.path.join(root, "filelists"), link)
                    os.chdir(wd)
                    extra = [f"--kernel_type={kernel}"]
                    t0 = time.perf_counter()
                    train.main(cli(shot, extra + ["--resume"] + stop),
                               device=device)
                    train_s = time.perf_counter() - t0
                    acc, ci, runs = test.main(
                        cli(shot, extra + [f"--repeat={args.repeat}"]
                            + n_iter), device=device, return_runs=True)
                    record({f"{key}_acc": acc, f"{key}_ci95": ci,
                            f"{key}_seed_std": float(np.std(runs)),
                            f"{key}_train_s": train_s})
                    print(f"== {kernel} {shot}-shot: {acc:.2f}% +- "
                          f"{ci:.2f}% (train {train_s:.0f} s) [{card}]",
                          flush=True)
                    os.chdir(root)
        finally:
            os.chdir(cwd)
    return rows


if __name__ == "__main__":
    main()
