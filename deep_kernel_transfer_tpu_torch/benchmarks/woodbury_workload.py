"""A real CLI workload of the port whose exact GPs take the Woodbury route.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.woodbury_workload \\
        --epochs 50 --repeat 2

Port of benchmarks/woodbury_workload.py. Every reference configuration
has N = n_way*(S+Q) <= 105 with D >= 1600, so ExactGP._use_low_rank
(kernel exactly low-rank and 2D <= N) never sends the paper's own
settings to the Woodbury route of gp/low_rank.py. This one does:

  * 250 synthetic stroke-glyph classes x 40 images at 28 px, drawn with
    digits_real._render_glyph_class from RandomState(23), split base 200 /
    val 25 / novel 25 under filelists/omniglot (the JAX script's names);
  * DKT with --dataset=omniglot --model=Conv4 (Conv4S, D = 64 features),
    the bncossim kernel, 20-way 15-shot, 16 train queries,
    --episode_batch=8, --seed=1: a training way-GP holds N = 20*(15+16) =
    620 points, beyond the fused MLL's N <= 128, so DKT._mll takes the
    batched ExactGP and its Woodbury MLL (2D = 128 <= 620); the eval
    conditions on N = 300 support points, the Woodbury posterior.

bench_step_ab times the same DKT train step and eval, fresh method objects
with force_dense off and on, episodes/s at --episode_batch (CUDA events
over 10 calls after 2 of warm-up on the card). Then `train.main` to
--epochs and `test.main` (600 episodes a run) with --repeat on both
arms, the arm set by DKT_GP_FORCE_DENSE on the same checkpoint and the
same episode stream. Every ExactGP route is recorded
(`recorded_routes`): the run fails unless the routed arm takes Woodbury at
N = 620 (train) and N = 300 (eval) and the force_dense arm the dense
route, and unless the fused-MLL kernel is launched no time (this path
runs cuBLAS and cuSOLVER products only).

Rows carry the JAX package's key names (glyphs20w_*, benchmarks/
report.json) with each run's seconds and the card's name and power limit,
and go to --report (woodbury_report.json beside this file by default),
merged after every row. Runs on CUDA; `main(argv, device="cpu")` runs on
the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from ._timing import card_of, merge_report
from .digits_real import _render_glyph_class

HERE = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(HERE, "woodbury_report.json")
N_WAY, N_SHOT, N_QUERY_TRAIN, N_QUERY_TEST, HW = 20, 15, 16, 15, 28
N_TRAIN = N_WAY * (N_SHOT + N_QUERY_TRAIN)  # 620 points a training way-GP
N_EVAL = N_WAY * N_SHOT  # 300 support points the eval conditions on
ARMS = {"woodbury": "glyphs20w_dkt_20way_15shot",
        "dense": "glyphs20w_dense_20way_15shot"}


def make_glyph_filelists(root: str, n_classes: int = 250,
                         n_img: int = 40) -> None:
    """The 250-class glyph set under root/filelists/omniglot (JAX
    benchmarks/woodbury_workload.py:41-76): glyphs/g{class}_{i}.jpg at
    quality 95, written once (a sentinel file marks them done), and the
    disjoint base 200 / val 25 / novel 25 split JSONs, rewritten every
    time."""
    from PIL import Image

    root = os.path.abspath(root)
    fl = os.path.join(root, "filelists", "omniglot")
    img_dir = os.path.join(fl, "glyphs")
    done = os.path.join(img_dir, f".complete_{n_classes}x{n_img}")
    names = [os.path.join(img_dir, f"g{cl}_{i}.jpg")
             for cl in range(n_classes) for i in range(n_img)]
    labels = [cl for cl in range(n_classes) for _ in range(n_img)]
    if not os.path.exists(done):
        os.makedirs(img_dir, exist_ok=True)
        rng = np.random.RandomState(23)
        it = iter(names)
        for _ in range(n_classes):
            for arr in _render_glyph_class(rng, n_img):
                Image.fromarray(arr).save(next(it), quality=95)
        open(done, "w").close()
        print(f"glyph dataset ready: {len(names)} images -> {img_dir}")
    names_np, labels_np = np.asarray(names), np.asarray(labels)
    splits = {"base": range(0, 200), "val": range(200, 225),
              "novel": range(225, 250)}
    for split, classes in splits.items():
        mask = np.isin(labels_np, list(classes))
        with open(os.path.join(fl, f"{split}.json"), "w") as f:
            json.dump({
                "label_names": [f"glyph_{c}" for c in range(n_classes)],
                "image_names": names_np[mask].tolist(),
                "image_labels": [int(c) for c in labels_np[mask]],
            }, f)


@contextlib.contextmanager
def recorded_routes():
    """A list that collects (N, Woodbury taken) for every
    ExactGP._use_low_rank decision made inside the block."""
    from ..gp.exact import ExactGP

    seen: list = []
    original = ExactGP._use_low_rank

    def use_low_rank(self, params, x):
        routed = original(self, params, x)
        seen.append((int(x.shape[-2]), bool(routed)))
        return routed

    ExactGP._use_low_rank = use_low_rank
    try:
        yield seen
    finally:
        ExactGP._use_low_rank = original


def check_routes(seen: list, woodbury: bool, sizes) -> dict:
    """{N: "woodbury" or "dense"} of the recorded decisions; raises unless
    each N of `sizes` was decided and every decision is the arm's."""
    routes: dict = {}
    for n, routed in seen:
        routes.setdefault(n, set()).add("woodbury" if routed else "dense")
    want = "woodbury" if woodbury else "dense"
    for n in sizes:
        if routes.get(n) != {want}:
            raise AssertionError(f"N = {n}: routes {routes.get(n)}, want "
                                 f"only {want}")
    return {n: "/".join(sorted(r)) for n, r in sorted(routes.items())}


def _seconds(fn, iters: int, device: torch.device) -> float:
    """Seconds of `iters` calls of fn: CUDA events on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def bench_step_ab(device, ep_batch: int = 8, iters: int = 10,
                  warmup: int = 2) -> dict:
    """Episodes/s of the 20-way 15-shot DKT train step (N = 620) and of its
    eval (batch_correct, N = 300 support and 300 queries) on uint8
    episodes drawn from a seed, with the Woodbury route and with
    force_dense, each arm a fresh DKT (Conv4S, bncossim) from one seed;
    the routes of each arm checked. Keys are the JAX rows' without the
    glyphs20w_ prefix, plus each arm's routes."""
    from ..methods import DKT
    from ..models import Conv4S

    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    xb = torch.randint(0, 256, (ep_batch, N_WAY, N_SHOT + N_QUERY_TRAIN, HW,
                                HW, 3), generator=gen, device=device,
                       dtype=torch.uint8)
    xe = xb[:, :, :N_SHOT + N_QUERY_TEST]
    out: dict = {}
    for arm in ("woodbury", "dense"):
        model = DKT(Conv4S(), N_WAY, N_SHOT, "bncossim",
                    force_dense=(arm == "dense"), device=device).init(
                        xb[0], torch.Generator().manual_seed(0))
        with recorded_routes() as seen:
            for _ in range(warmup):
                model.train_step(xb)
                model.batch_correct(xe)
        out[f"{arm}_routes"] = check_routes(seen, arm == "woodbury",
                                            (N_TRAIN, N_EVAL))
        s = _seconds(lambda: model.train_step(xb), iters, device)
        out[f"{arm}_train_eps_per_sec"] = iters * ep_batch / s
        s = _seconds(lambda: model.batch_correct(xe), iters, device)
        out[f"{arm}_eval_eps_per_sec"] = iters * ep_batch / s
        del model
    return out


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--episode_batch", type=int, default=8)
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .. import test, train
    from .._device import resolve_device
    from ..ops.fused_mll import fused_linear_mll

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    card = card_of(device)
    rows: dict = {}

    def record(row: dict) -> None:
        rows.update(row)
        merge_report(report, row)

    record({"glyphs20w_card": card, "glyphs20w_protocol": (
        "Woodbury-routed workload: 250 synthetic glyph classes (base 200/"
        "val 25/novel 25), DKT Conv4S bncossim 20-way 15-shot via the "
        "port's train/test; train N=620 (2D=128<=N -> gp/exact.py Woodbury "
        "mll), eval conditions on N=300 (Woodbury posterior); dense arms "
        "build the same step with force_dense=True; glyphs20w_dense_*_acc "
        "is the same checkpoint and episode stream scored through the "
        "dense route")})
    fused_linear_mll.launches = 0
    entry = bench_step_ab(device, args.episode_batch)
    record({f"glyphs20w_{k}": v for k, v in entry.items()})
    print(json.dumps(entry), flush=True)
    _cli_runs(args, device, card, record, train, test)
    if fused_linear_mll.launches:
        raise AssertionError(f"the Woodbury workload launched the fused MLL "
                             f"{fused_linear_mll.launches} times")
    print(json.dumps(rows), flush=True)
    return rows


@contextlib.contextmanager
def _force_dense(on: bool):
    """DKT_GP_FORCE_DENSE set to "1" or "0" inside the block, restored
    after it."""
    before = os.environ.get("DKT_GP_FORCE_DENSE")
    os.environ["DKT_GP_FORCE_DENSE"] = "1" if on else "0"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("DKT_GP_FORCE_DENSE")
        else:
            os.environ["DKT_GP_FORCE_DENSE"] = before


def _cli_runs(args, device, card, record, train, test) -> None:
    """train.main to --epochs on the Woodbury route, then test.main on
    both arms, in --root or a temporary directory."""
    common = ["--dataset=omniglot", "--model=Conv4", "--method=DKT",
              f"--train_n_way={N_WAY}", f"--test_n_way={N_WAY}",
              f"--n_shot={N_SHOT}", "--seed=1",
              f"--episode_batch={args.episode_batch}"]
    cwd = os.getcwd()
    workdir = (contextlib.nullcontext(args.root) if args.root
               else tempfile.TemporaryDirectory())
    with workdir as root:
        root = os.path.abspath(root)
        make_glyph_filelists(root)
        os.chdir(root)
        try:
            t0 = time.perf_counter()
            with _force_dense(False), recorded_routes() as seen:
                train.main(common + ["--resume",
                                     f"--stop_epoch={args.epochs}"],
                           device=device)
            record({"glyphs20w_dkt_train_s": time.perf_counter() - t0,
                    "glyphs20w_train_routes": check_routes(
                        seen, True, (N_TRAIN, N_EVAL))})
            for arm, key in ARMS.items():
                t0 = time.perf_counter()
                with _force_dense(arm == "dense"), recorded_routes() as seen:
                    acc, ci = test.main(common + [f"--repeat={args.repeat}"],
                                        device=device)
                record({f"{key}_acc": acc, f"{key}_ci95": ci,
                        f"{key}_test_s": time.perf_counter() - t0,
                        f"{key}_routes": check_routes(
                            seen, arm == "woodbury", (N_EVAL,))})
                print(f"== glyphs 20-way 15-shot [{arm}]: {acc:.2f}% +- "
                      f"{ci:.2f}% (chance {100 / N_WAY:.0f}%) [{card}]",
                      flush=True)
        finally:
            os.chdir(cwd)


if __name__ == "__main__":
    main()
