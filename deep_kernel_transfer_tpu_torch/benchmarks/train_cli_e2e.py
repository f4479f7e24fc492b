"""Episodes a second of the `train` CLI end to end: the user's own path.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.train_cli_e2e

Port of JAX benchmarks/train_cli_e2e.py:30-100. It writes the JAX
script's synthetic set (30 classes x 40 images of 84x84x3 from
RandomState(0), JPEG quality 90, CUB layout with base = val; the bytes
equal the JAX make_dataset's) and runs the port's `train.main` with the
JAX script's flags: DKT, Conv4, bncossim, --train_aug, --device_data=on,
16 episodes a batch, --n_train_episodes=200 (staging into device memory,
episodes drawn and augmented on the card, the train step, the telemetry,
the validation after every epoch, the checkpoints). Each run of main
builds its model anew and pays a fixed cost (staging, cuDNN's first
plans), so a 1-epoch run and a (1 + N)-epoch run are timed and
differenced: warm epoch = (t(1 + N) - t(1)) / N, after a first cold
1-epoch run whose time is reported too.

Rows train_cli_e2e_eps_per_sec, train_cli_cold_first_epoch_s,
train_cli_fixed_overhead_s and train_cli_warm_epoch_s (the JAX key names)
go to --report (studies_report.json beside this file) with the card's
name and power limit. --episodes and --epochs cut the run (the tests run
it small). Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
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
from .profile_step import REPORT

N_CLASSES, N_IMG, HW = 30, 40, 84
N_EPISODES, N_EPOCHS, EPISODE_BATCH = 200, 8, 16


def make_dataset(root: str) -> None:
    """The JAX script's set under root/filelists/CUB (train_cli_e2e.py
    :30-53): the same draws, JPEG files and split JSONs."""
    from PIL import Image

    img_dir = os.path.join(root, "filelists", "CUB", "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    names, labels = [], []
    for cl in range(N_CLASSES):
        for i in range(N_IMG):
            arr = (rng.rand(HW, HW, 3) * 70).astype(np.uint8)
            r, c = divmod(cl % 9, 3)
            arr[r * 25:r * 25 + 20, c * 25:c * 25 + 20, :] += 150
            p = os.path.join(img_dir, f"c{cl}_{i}.jpg")
            Image.fromarray(arr).save(p, quality=90)
            names.append(p)
            labels.append(cl)
    meta = {"label_names": [f"c{i}" for i in range(N_CLASSES)],
            "image_names": names, "image_labels": labels}
    for split in ("base", "val"):
        with open(os.path.join(root, "filelists", "CUB", f"{split}.json"),
                  "w") as f:
            json.dump(meta, f)


def train_args(episodes: int) -> list:
    """The JAX script's train flags (train_cli_e2e.py:66-70)."""
    return ["--dataset=CUB", "--model=Conv4", "--method=DKT",
            "--train_n_way=5", "--test_n_way=5", "--n_shot=5", "--seed=1",
            "--train_aug", "--device_data=on",
            f"--episode_batch={EPISODE_BATCH}",
            f"--n_train_episodes={episodes}", "--save_freq=1000"]


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--episodes", type=int, default=N_EPISODES,
                    help="--n_train_episodes of each run")
    ap.add_argument("--epochs", type=int, default=N_EPOCHS,
                    help="N, the epochs the long run adds")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .. import train
    from .._device import resolve_device
    from ..data import device_dataset

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    cli = train_args(args.episodes)
    cwd = os.getcwd()
    workdir = (contextlib.nullcontext(args.root) if args.root
               else tempfile.TemporaryDirectory())
    with workdir as root:
        root = os.path.abspath(root)
        if not os.path.isdir(os.path.join(root, "filelists", "CUB",
                                          "images")):
            make_dataset(root)
        os.chdir(root)
        try:
            wall = []
            for stop in (1, 1, 1 + args.epochs):  # cold, fixed cost, long
                t0 = time.perf_counter()
                train.main(cli + [f"--stop_epoch={stop}"], device=device)
                wall.append(time.perf_counter() - t0)
        finally:
            os.chdir(cwd)
            device_dataset._CACHE.clear()
    cold_s, one_s, many_s = wall
    epoch_s = (many_s - one_s) / args.epochs
    rows = {"train_cli_e2e_eps_per_sec": args.episodes / epoch_s,
            "train_cli_cold_first_epoch_s": cold_s,
            "train_cli_fixed_overhead_s": one_s - epoch_s,
            "train_cli_warm_epoch_s": epoch_s,
            "train_cli_card": card_of(device),
            "train_cli_protocol": (
                f"deep_kernel_transfer_tpu_torch.benchmarks.train_cli_e2e: "
                f"train.main (DKT, Conv4, --train_aug, --device_data=on, "
                f"--episode_batch={EPISODE_BATCH}, --n_train_episodes="
                f"{args.episodes}) on 30 classes x 40 84-px JPEGs; warm epoch"
                f" = (t({1 + args.epochs} epochs) - t(1 epoch)) / "
                f"{args.epochs}, host clock around each run")}
    merge_report(report, rows)
    for k, v in rows.items():
        print(f"{k}: {v}", flush=True)
    return rows


if __name__ == "__main__":
    main()
