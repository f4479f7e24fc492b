"""Accuracy of the port's regression track against the JAX package's rows.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.regression_real \\
        --tracks=paper,qmul,sines,sines_readme --seeds=1,2,3 --skip_existing

Port of the protocols of benchmarks/paper_protocol.py:42-126 and
benchmarks/coverage.py:40-185, through the port's entry points, on a
synthetic QMUL face grid (this module's copy of `render_face` and
`make_synthetic_qmul`: all 29 people, 13 pitches x 19 angles of 100-px
JPEGs whose pose is drawn visibly) and on sines, which needs no data:

  * paper: `train_regression` (DKT, seed 1, 100 epochs) then
    `test_regression --n_support=5 --n_test_epochs=10`, rbf and
    --spectral; the paper's ordering is spectral below rbf;
  * qmul: per seed, `train_regression` for 100 epochs, then the coverage
    of the +-2 sigma band of the noise-inclusive posterior and the MSE
    over 50 5-shot test trajectories of 19 points, rbf and spectral;
  * sines: per seed, the sines DKT trained for 50,000 one-task steps, then
    coverage and MSE over 500 5-shot tasks of 195 query points;
  * sines_readme: `sines.train_DKT --task_batch=8 --iterations=50000`, 500
    tasks (README: JAX 0.0174 +- 0.0063, the paper about 0.02).

Rows carry the JAX package's key names (benchmarks/report.json) with each
run's seconds, beside the JAX rows copied in as JAX_ROWS, and go to
--report (regression_report.json beside this file by default) with the
card's name and power limit, merged after every row; --skip_existing
skips a track whose rows the report holds. Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ._timing import card_of, merge_report

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(HERE, "regression_report.json")

# the JAX package's rows (benchmarks/report.json), accuracy not time
JAX_ROWS = {
    "qmul_synthetic_dkt_rbf_mse": 0.2477,
    "qmul_synthetic_dkt_rbf_mse_std": 0.158,
    "qmul_synthetic_dkt_spectral_mse": 0.0289,
    "qmul_synthetic_dkt_spectral_mse_std": 0.0239,
    "sines_dkt_coverage95": 0.9623,
    "sines_dkt_coverage95_std": 0.016,
    "sines_dkt_mse_multiseed": 0.1159,
    "qmul_synthetic_dkt_rbf_coverage95": 0.994,
    "qmul_synthetic_dkt_rbf_coverage95_std": 0.0084,
    "qmul_synthetic_dkt_rbf_mse_multiseed": 0.0748,
    "qmul_synthetic_dkt_spectral_coverage95": 0.9716,
    "qmul_synthetic_dkt_spectral_coverage95_std": 0.0156,
    "qmul_synthetic_dkt_spectral_mse_multiseed": 0.1804,
    "sines_dkt_readme_mse": 0.0174,
    "sines_dkt_readme_mse_std": 0.0063,
}
COVERAGE_BAND = 0.03  # coverage rows: within this of the JAX row
SINES_README_MAX = 0.03  # the README protocol's MSE


def render_face(person_seed: int, pitch: int, angle: int, size: int = 100):
    """A deterministic synthetic face whose pose is visible: the head
    ellipse rises with the pitch, the pupils follow the yaw angle (copy of
    benchmarks/paper_protocol.py:42-68)."""
    rng = np.random.RandomState(person_seed * 7919 + pitch * 131 + angle)
    prng = np.random.RandomState(person_seed)
    img = np.full((size, size, 3), 60 + prng.randint(0, 60), np.float32)
    img += rng.randn(size, size, 3) * 8  # sensor noise
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)

    cy = size * (0.70 - 0.40 * pitch / 120.0) + prng.randn() * 2
    cx = size * 0.5 + prng.randn() * 2
    ry = size * (0.28 + 0.02 * prng.rand())
    rx = size * (0.20 + 0.02 * prng.rand())
    head = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    skin = 150 + prng.randint(0, 60)
    img[head] = [skin, skin * 0.85, skin * 0.7]

    off = (angle - 90.0) / 90.0 * rx * 0.45
    for side in (-1, 1):
        ex = cx + side * rx * 0.45 + off
        ey = cy - ry * 0.15
        eye = (yy - ey) ** 2 + (xx - ex) ** 2 <= (size * 0.025) ** 2
        img[eye] = 20
    return np.clip(img, 0, 255).astype(np.uint8)


def make_synthetic_qmul(root: str, size: int = 100, threads: int = 8) -> int:
    """The synthetic grid under root/filelists/QMUL/images in the QMUL
    naming, written by `threads` threads, one person each (copy of
    benchmarks/paper_protocol.py:71-91). Returns the number of images;
    0 when root already holds a complete grid."""
    from PIL import Image

    from ..data import qmul

    img_dir = os.path.join(root, "filelists", "QMUL", "images")
    done_marker = os.path.join(img_dir, ".complete")
    if os.path.exists(done_marker):
        return 0
    people = qmul.train_people + qmul.test_people

    def write(pi: int) -> int:
        os.makedirs(os.path.join(img_dir, people[pi]), exist_ok=True)
        n = 0
        for pitch in range(0, 130, 10):
            for angle in range(0, 190, 10):
                Image.fromarray(render_face(pi, pitch, angle, size)).save(
                    qmul.face_file(img_dir, people[pi], pitch, angle),
                    quality=92)
                n += 1
        return n

    with ThreadPoolExecutor(threads) as pool:
        n = sum(pool.map(write, range(len(people))))
    open(done_marker, "w").close()
    return n


def band_coverage(pred, y) -> float:
    """Share of the targets inside confidence_region() (+-2 sigma)."""
    lower, upper = pred.confidence_region()
    return float(((lower <= y) & (y <= upper)).float().mean())


def run_paper(record, device, epochs: int) -> None:
    """paper_protocol's rows: DKT rbf and spectral, seed 1, in the cwd."""
    from .. import test_regression, train_regression

    mses = {}
    for kernel in ("rbf", "spectral"):
        flags = ["--method=DKT", "--seed=1"] + (
            ["--spectral"] if kernel == "spectral" else [])
        t0 = time.perf_counter()
        train_regression.main(flags + [f"--stop_epoch={epochs}"], device)
        train_s = time.perf_counter() - t0
        mse, std = test_regression.main(
            flags + ["--n_test_epochs=10", "--n_support=5"], device)
        mses[kernel] = mse
        record({f"qmul_synthetic_dkt_{kernel}_mse": mse,
                f"qmul_synthetic_dkt_{kernel}_mse_std": std,
                f"qmul_synthetic_{kernel}_train_s": train_s})
    record({"qmul_synthetic_spectral_below_rbf":
            bool(mses["spectral"] < mses["rbf"])})


def qmul_coverage(seed: int, kernel: str, epochs: int, n_test: int,
                  device) -> tuple[float, float]:
    """(coverage95, MSE) of the synthetic-QMUL DKT trained by the CLI,
    over n_test random 5-shot test-person trajectories (JAX
    benchmarks/coverage.py:89-126)."""
    import torch

    from .. import train_regression
    from ..data.qmul import get_batch, test_people

    flags = ["--method=DKT", f"--seed={seed}", f"--stop_epoch={epochs}"]
    if kernel == "spectral":
        flags.append("--spectral")
    model = train_regression.main(flags, device)
    rng = np.random.RandomState(seed)
    covs, mses = [], []
    for _ in range(n_test):
        person = [test_people[rng.randint(len(test_people))]]
        x, y = get_batch(person, rng)
        x = torch.from_numpy(x[0]).to(model.device)
        y = torch.from_numpy(y[0]).to(model.device)
        idx = torch.from_numpy(rng.choice(19, 5, replace=False)).to(
            model.device)
        pred = model.predict(x[idx], y[idx], x)
        covs.append(band_coverage(pred, y))
        mses.append(float(torch.mean((pred.mean - y) ** 2)))
    return float(np.mean(covs)), float(np.mean(mses))


def sines_coverage(seed: int, iters: int, n_test: int, task_batch: int,
                   device) -> tuple[float, float]:
    """(coverage95, MSE) of the sines DKT (sines.train_DKT's law) over
    n_test 5-shot tasks (JAX benchmarks/coverage.py:49-86)."""
    import torch

    from ..methods import DKTRegression
    from ..models.backbones import MLP2
    from ..sines import common

    rng = np.random.RandomState(seed)
    tasks = common.train_tasks()
    model = DKTRegression(MLP2(), feat_dim=40, kernel_type="spectral",
                          lr=1e-3, device=device)
    model.init(torch.zeros((10, 1)), torch.Generator().manual_seed(seed))
    dev = model.device
    for it in range(iters // task_batch):
        xb, yb = tasks.sample_batch(rng, task_batch, common.N_SHOT_TRAIN,
                                    noise=0.1)
        m = model.train_step(torch.from_numpy(xb).to(dev),
                             torch.from_numpy(yb).to(dev))
        if it % 5000 == 0:
            print(f"[sines seed {seed}] {it * task_batch}/{iters} "
                  f"loss {float(m['loss']):.3f}", flush=True)
    tt = common.test_tasks(out_of_range=False)
    covs, mses = [], []
    for _ in range(n_test):
        _, xs, ys, xq, yq, _, _ = common.sample_eval_task(rng, tt)
        xs, ys, xq, yq = (torch.from_numpy(a).to(dev)
                          for a in (xs, ys, xq, yq))
        pred = model.predict(xs, ys, xq)
        covs.append(band_coverage(pred, yq))
        mses.append(float(torch.mean((pred.mean - yq) ** 2)))
    return float(np.mean(covs)), float(np.mean(mses))


def _multiseed(record, prefix: str, mse_key: str, runs: dict) -> None:
    """Per-seed rows, then mean and std over the seeds."""
    covs = [c for c, _ in runs.values()]
    mses = [m for _, m in runs.values()]
    record({f"{prefix}_coverage95": float(np.mean(covs)),
            f"{prefix}_coverage95_std": float(np.std(covs)),
            mse_key: float(np.mean(mses))})


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tracks", default="paper,qmul,sines,sines_readme")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--qmul_epochs", type=int, default=100)
    ap.add_argument("--qmul_kernels", default="rbf,spectral")
    ap.add_argument("--qmul_test_epochs", type=int, default=50)
    ap.add_argument("--sines_iters", type=int, default=50000)
    ap.add_argument("--n_test_tasks", type=int, default=500)
    ap.add_argument("--skip_existing", action="store_true",
                    help="skip a track whose rows are in the report")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)
    tracks = args.tracks.split(",")
    seeds = [int(s) for s in args.seeds.split(",")]

    from .._device import resolve_device

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    existing = {}
    if os.path.exists(report):
        with open(report) as f:
            existing = json.load(f)
    card = card_of(device)
    merge_report(report, {"card": card, "jax_rows": JAX_ROWS})
    rows: dict = {}

    def record(row: dict) -> None:
        print(json.dumps(row), flush=True)
        rows.update(row)
        merge_report(report, row)

    def wanted(track: str, key: str) -> bool:
        if track not in tracks:
            return False
        if args.skip_existing and key in existing:
            print(f"-- skip {track} ({key} is in the report)", flush=True)
            return False
        return True

    cwd = os.getcwd()
    workdir = (contextlib.nullcontext(args.root) if args.root
               else tempfile.TemporaryDirectory())
    with workdir as root:
        root = os.path.abspath(root)
        try:
            if any(t in tracks for t in ("paper", "qmul")):
                t0 = time.perf_counter()
                n = make_synthetic_qmul(root)
                print(f"synthetic QMUL grid: {n} images in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            os.chdir(root)
            if wanted("paper", "qmul_synthetic_dkt_spectral_mse"):
                run_paper(record, device, args.qmul_epochs)
            for kernel in args.qmul_kernels.split(","):
                prefix = f"qmul_synthetic_dkt_{kernel}"
                if not wanted("qmul", f"{prefix}_coverage95"):
                    continue
                runs = {}
                for seed in seeds:
                    t0 = time.perf_counter()
                    runs[seed] = qmul_coverage(seed, kernel,
                                               args.qmul_epochs,
                                               args.qmul_test_epochs, device)
                    record({f"{prefix}_seed{seed}_coverage95": runs[seed][0],
                            f"{prefix}_seed{seed}_mse": runs[seed][1],
                            f"{prefix}_seed{seed}_s":
                                time.perf_counter() - t0})
                _multiseed(record, prefix, f"{prefix}_mse_multiseed", runs)
            if wanted("sines", "sines_dkt_coverage95"):
                runs = {}
                for seed in seeds:
                    t0 = time.perf_counter()
                    runs[seed] = sines_coverage(seed, args.sines_iters,
                                                args.n_test_tasks, 1, device)
                    record({f"sines_dkt_seed{seed}_coverage95": runs[seed][0],
                            f"sines_dkt_seed{seed}_mse": runs[seed][1],
                            f"sines_dkt_seed{seed}_s":
                                time.perf_counter() - t0})
                _multiseed(record, "sines_dkt", "sines_dkt_mse_multiseed",
                           runs)
            if wanted("sines_readme", "sines_dkt_readme_mse"):
                from ..sines import train_DKT

                t0 = time.perf_counter()
                mses = train_DKT.main(
                    ["--task_batch=8", f"--iterations={args.sines_iters}",
                     f"--n_test_tasks={args.n_test_tasks}"], device)
                record({"sines_dkt_readme_mse": float(np.mean(mses)),
                        "sines_dkt_readme_mse_std": float(np.std(mses)),
                        "sines_dkt_readme_s": time.perf_counter() - t0})
        finally:
            os.chdir(cwd)
    record({"bands": bands(existing | rows)})
    return rows


def bands(rows: dict) -> dict:
    """Each banded row against its JAX row: coverage within COVERAGE_BAND,
    the README sines MSE at most SINES_README_MAX; the MSE rows of single
    runs have no band."""
    out = {}
    for key in ("sines_dkt_coverage95", "qmul_synthetic_dkt_rbf_coverage95",
                "qmul_synthetic_dkt_spectral_coverage95"):
        if key in rows:
            diff = rows[key] - JAX_ROWS[key]
            out[key] = {"port": rows[key], "jax": JAX_ROWS[key],
                        "diff": diff, "in_band": abs(diff) <= COVERAGE_BAND}
    if "sines_dkt_readme_mse" in rows:
        out["sines_dkt_readme_mse"] = {
            "port": rows["sines_dkt_readme_mse"],
            "jax": JAX_ROWS["sines_dkt_readme_mse"],
            "in_band": rows["sines_dkt_readme_mse"] <= SINES_README_MAX}
    return out


if __name__ == "__main__":
    main()
