"""Real-image few-shot accuracy of the port: scikit-learn's handwritten
digits through the port's CLIs.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.digits_real \\
        --shots=5 --repeat=3 --dkt_variants --ece

Port of benchmarks/digits_real.py and of benchmarks/calibration.py, with
no scikit-learn: the 1797 8x8 digits (values 0..16) and their labels are
read from `digits.npz` beside this file, written once from
`sklearn.datasets.load_digits`.

  * Default (digits_real): 28-px bicubic JPEGs of the digits; base = val =
    digits 0-4, novel = digits 5-9.
  * --cross (digits_cross): base = 200 synthetic stroke-glyph classes of 20
    images drawn with PIL from RandomState(11); val = even digits, novel =
    odd digits.

For each method of --methods (the JAX runner's names; `zoo` is its ZOO
list, JAX benchmarks/digits_real.py:171-172) and each shot it trains once
with the JAX rows' flags (--dataset=omniglot --model=Conv4 --train_n_way=5
--test_n_way=5 --n_shot=S --seed=1 --method=M, the default stop epoch;
MAML at maml_budget_epochs, the baselines with --num_classes=4112 and
trained once for all shots), writes the feature cache with save_features
for the methods that test from it, then tests with --repeat reseeded runs
of 600 episodes. For DKT, --dkt_variants adds the --laplace and
--adaptation heads on the same checkpoint. --ece adds each method's
calibration study (test_uncertainty at --episode_batch=32, as
benchmarks/calibration.py runs it: from images for DKT and MAML, from the
feature cache for the rest), rows {tag}_ece_{method}_{shot}shot_*.
Rows carry the JAX package's key names (benchmarks/report.json), with
each run's wall time, and go to --report (digits_report.json beside this
file by default) with the card's name and power limit, merged after every
row; --skip_existing skips a (method, shot) whose accuracy row the
report already holds, so one method can run per call. Runs on CUDA;
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

HERE = os.path.dirname(os.path.abspath(__file__))
ZOO = ("protonet,DKT,matchingnet,relationnet,relationnet_softmax,"
       "baseline,baseline++,maml_approx,maml")
FROM_IMAGES = ("DKT", "maml", "maml_approx")
DIGITS = os.path.join(HERE, "digits.npz")
REPORT = os.path.join(HERE, "digits_report.json")


def load_digits_array() -> tuple[np.ndarray, np.ndarray]:
    """(images [1797, 64] float64 in 0..16, labels [1797] int64), the
    values of sklearn.datasets.load_digits(return_X_y=True)."""
    with np.load(DIGITS) as f:
        return f["images"].astype(np.float64), f["labels"].astype(np.int64)


def _split_json(path: str, names: np.ndarray, labels: np.ndarray, classes,
                label_names: list) -> None:
    mask = np.isin(labels, list(classes))
    with open(path, "w") as f:
        json.dump({"label_names": label_names,
                   "image_names": names[mask].tolist(),
                   "image_labels": [int(c) for c in labels[mask]]}, f)


def make_digits_filelists(root: str) -> None:
    """The omniglot-layout filelists of the digits under root/filelists/
    omniglot (JAX benchmarks/digits_real.py:57-93): 8x8 -> 28x28 bicubic
    JPEGs at quality 95, written once (a sentinel file marks them done);
    the split JSONs are rewritten every time."""
    from PIL import Image

    root = os.path.abspath(root)
    img_dir = os.path.join(root, "filelists", "omniglot", "images")
    done = os.path.join(img_dir, ".complete")
    x, y = load_digits_array()
    names = [os.path.join(img_dir, f"d{cl}_{i}.jpg") for i, cl in enumerate(y)]
    if not os.path.exists(done):
        os.makedirs(img_dir, exist_ok=True)
        for p, row in zip(names, x):
            arr = (row.reshape(8, 8) / 16.0 * 255.0).round().astype(np.uint8)
            Image.fromarray(arr).resize((28, 28), Image.BICUBIC).save(
                p, quality=95)
        open(done, "w").close()
        print(f"digits dataset ready: {len(names)} images -> {img_dir}")
    fl = os.path.join(root, "filelists", "omniglot")
    label_names = [f"digit_{c}" for c in range(10)]
    names_np = np.asarray(names)
    _split_json(os.path.join(fl, "base.json"), names_np, y, range(5),
                label_names)
    _split_json(os.path.join(fl, "val.json"), names_np, y, range(5),
                label_names)  # no novel class leaks into model selection
    _split_json(os.path.join(fl, "novel.json"), names_np, y, range(5, 10),
                label_names)


def _render_glyph_class(rng: np.random.RandomState, n_img: int) -> list:
    """n_img 28x28 uint8 images of one synthetic stroke-glyph class: 2-4
    quadratic Bezier strokes, each image with a small affine jitter, stroke
    point noise and background noise, white on black (JAX
    benchmarks/digits_real.py:96-127)."""
    from PIL import Image, ImageDraw

    n_strokes = rng.randint(2, 5)
    strokes = rng.rand(n_strokes, 3, 2) * 20 + 4  # control points, 20x20 box
    out = []
    for _ in range(n_img):
        img = Image.new("L", (28, 28), 0)
        draw = ImageDraw.Draw(img)
        ang = rng.randn() * 0.12
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]])
        scale = 1.0 + rng.randn() * 0.08
        shift = rng.randn(2) * 1.2
        for s in strokes:
            p = s + rng.randn(3, 2) * 0.6
            p = (p - 14) @ rot.T * scale + 14 + shift
            t = np.linspace(0, 1, 12)[:, None]
            pts = (1 - t) ** 2 * p[0] + 2 * t * (1 - t) * p[1] + t ** 2 * p[2]
            draw.line([tuple(q) for q in pts], fill=255,
                      width=int(rng.randint(2, 4)))
        arr = np.asarray(img, np.uint8)
        noise = (rng.rand(28, 28) * 40).astype(np.uint8)
        out.append(np.maximum(arr, noise))
    return out


def make_cross_filelists(root: str, n_classes: int = 200,
                         n_img: int = 20) -> None:
    """The cross-domain layout (JAX benchmarks/digits_real.py:130-172):
    base = synthetic stroke glyphs; the digits split by parity, val = even,
    novel = odd, as the reference splits EMNIST."""
    from PIL import Image

    root = os.path.abspath(root)
    make_digits_filelists(root)
    fl = os.path.join(root, "filelists", "omniglot")
    img_dir = os.path.join(fl, "glyphs")
    done = os.path.join(img_dir, f".complete_{n_classes}x{n_img}")
    names = [os.path.join(img_dir, f"g{cl}_{i}.jpg")
             for cl in range(n_classes) for i in range(n_img)]
    labels = [cl for cl in range(n_classes) for _ in range(n_img)]
    if not os.path.exists(done):
        os.makedirs(img_dir, exist_ok=True)
        rng = np.random.RandomState(11)
        it = iter(names)
        for _ in range(n_classes):
            for arr in _render_glyph_class(rng, n_img):
                Image.fromarray(arr).save(next(it), quality=95)
        open(done, "w").close()
        print(f"glyph base ready: {len(names)} images -> {img_dir}")
    with open(os.path.join(fl, "base.json"), "w") as f:
        json.dump({"label_names": [f"glyph_{c}" for c in range(n_classes)],
                   "image_names": names, "image_labels": labels}, f)
    _, y = load_digits_array()
    dig_dir = os.path.join(fl, "images")
    dnames = np.asarray([os.path.join(dig_dir, f"d{cl}_{i}.jpg")
                         for i, cl in enumerate(y)])
    label_names = [f"digit_{c}" for c in range(10)]
    _split_json(os.path.join(fl, "val.json"), dnames, y, (0, 2, 4, 6, 8),
                label_names)
    _split_json(os.path.join(fl, "novel.json"), dnames, y, (1, 3, 5, 7, 9),
                label_names)


def maml_budget_epochs(shot: int) -> int:
    """MAML's --stop_epoch for episode-count parity with the other
    methods' budgets (JAX benchmarks/digits_real.py:175-187): train
    multiplies it by n_task = 32 on character data, at 4 batches an epoch,
    so 15 -> 61,440 episodes at 1-shot and 10 -> 40,960 at 5-shot."""
    return 15 if shot == 1 else 10


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--methods", default="DKT",
                    help=f"comma list, or 'zoo' = {ZOO}")
    ap.add_argument("--shots", default="5")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=-1,
                    help="-1 = the default stop epoch for the method/shot")
    ap.add_argument("--n_iter", type=int, default=600,
                    help="test episodes a run")
    ap.add_argument("--cross", action="store_true")
    ap.add_argument("--dkt_variants", action="store_true",
                    help="also test DKT's --laplace and --adaptation heads")
    ap.add_argument("--ece", action="store_true",
                    help="also run each method's calibration study")
    ap.add_argument("--skip_existing", action="store_true",
                    help="skip a method and shot whose accuracy row is "
                         "already in the report")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)
    methods = (ZOO if args.methods == "zoo" else args.methods).split(",")

    from .. import save_features, test, test_uncertainty, train
    from .._device import resolve_device

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    card = card_of(device)
    tag = "digits_cross" if args.cross else "digits_real"
    existing = {}
    if os.path.exists(report):
        with open(report) as f:
            existing = json.load(f)
    merge_report(report, {f"{tag}_card": card})
    rows: dict = {}

    def record(row: dict) -> None:
        rows.update(row)
        merge_report(report, row)

    cwd = os.getcwd()
    workdir = (contextlib.nullcontext(args.root) if args.root
               else tempfile.TemporaryDirectory())
    with workdir as root:
        root = os.path.abspath(root)
        (make_cross_filelists if args.cross else make_digits_filelists)(root)
        os.chdir(root)
        try:
            trained: set = set()  # a baseline's checkpoint has no shot
            for method in methods:
                for shot in (int(s) for s in args.shots.split(",")):
                    key = f"{tag}_{method.lower()}_5way_{shot}shot"
                    if args.skip_existing and f"{key}_acc" in existing:
                        print(f"-- skip {key} (in the report)", flush=True)
                        continue
                    _run_method(method, shot, key, tag, args, device, card,
                                trained, record, train, save_features, test,
                                test_uncertainty)
        finally:
            os.chdir(cwd)
    print(json.dumps(rows))
    return rows


def _run_method(method, shot, key, tag, args, device, card, trained, record,
                train, save_features, test, test_uncertainty) -> None:
    """Train (once for a baseline), cache the features where the method
    tests from them, test, and record the rows of one method and shot."""
    common = ["--dataset=omniglot", "--model=Conv4", "--train_n_way=5",
              "--test_n_way=5", f"--n_shot={shot}", "--seed=1",
              f"--method={method}"]
    is_baseline = method in ("baseline", "baseline++")
    epochs = args.epochs
    if epochs == -1 and method in ("maml", "maml_approx"):
        epochs = maml_budget_epochs(shot)
    row = {}
    if not (is_baseline and method in trained):
        t0 = time.perf_counter()
        train.main(common + ([f"--stop_epoch={epochs}"] if epochs != -1
                             else [])
                   + (["--num_classes=4112"] if is_baseline else []),
                   device=device)
        row[f"{key}_train_s"] = time.perf_counter() - t0
        if method not in FROM_IMAGES:
            t0 = time.perf_counter()
            save_features.main(common + ["--split=novel"], device=device)
            row[f"{key}_features_s"] = time.perf_counter() - t0
        trained.add(method)
    heads = [(method.lower(), [])]
    if method == "DKT" and args.dkt_variants:
        heads += [("dkt_laplace", ["--laplace"]),
                  ("dkt_adaptation", ["--adaptation"])]
    for name, flags in heads:
        head_key = f"{tag}_{name}_5way_{shot}shot"
        t0 = time.perf_counter()
        acc, ci, runs = test.main(
            common + [f"--repeat={args.repeat}", f"--n_iter={args.n_iter}"]
            + flags, device=device, return_runs=True)
        row.update({f"{head_key}_acc": acc, f"{head_key}_ci95": ci,
                    f"{head_key}_seed_std": float(np.std(runs)),
                    f"{head_key}_test_s": time.perf_counter() - t0})
        record(row)
        row = {}
        print(f"== {head_key}: {acc:.2f}% +- {ci:.2f}% (seed std "
              f"{np.std(runs):.2f}) [{card}]", flush=True)
    if args.ece:
        ece_key = f"{tag}_ece_{method.lower()}_{shot}shot"
        t0 = time.perf_counter()
        out = test_uncertainty.main(
            common + [f"--repeat={args.repeat}", f"--n_iter={args.n_iter}",
                      "--episode_batch=32"], device=device)
        record({f"{ece_key}_raw": out["ece_raw"],
                f"{ece_key}_raw_std": out["ece_raw_std"],
                f"{ece_key}_cal": out["ece_cal"],
                f"{ece_key}_cal_std": out["ece_cal_std"],
                f"{ece_key}_temp": out["temperature"],
                f"{ece_key}_acc": out["acc"],
                f"{ece_key}_s": time.perf_counter() - t0})
        print(f"== {ece_key}: raw {out['ece_raw']:.4f}, calibrated "
              f"{out['ece_cal']:.4f}, T {out['temperature']:.3f} [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
