"""DKT's --laplace head on the digits through three arms, one checkpoint
and one set of episodes.

    python -m deep_kernel_transfer_tpu_torch.benchmarks.laplace_probe \\
        --shots=1,5 --episodes=100

Port of JAX benchmarks/laplace_probe.py:37-165. The reference head
(reference methods/DKT.py:207-222) discards the learned GP and fits
scikit-learn's GaussianProcessClassifier(1.0 * RBF(0.1), optimizer=None),
one-vs-rest, to the support features; on unit-norm features the RBF(0.1)
Gram is nearly the identity, so the head is prior-dominated. The probe
scores the default bncossim run's best checkpoint (digits_real filelists,
Conv4S, 5-way, seed 1) on the same novel episodes (the host loader, seed
7, one episode a batch, 15 queries) through

  (a) ours: `gp/laplace.py::laplace_ovr_predict`, on the device in f32;
  (b) sklearn: `sklearn_gpc.py`, this package's float64 copy of
      scikit-learn's classifier, on the host, fed the features copied off
      the device;
  (c) gp: the learned-kernel GP head, `episode_scores`;

and records the mean off-diagonal `rbf_gram` of each support set. The
default run is trained where its checkpoints are missing, as
`dkt_sweep.py` does; --epochs cuts that run (its best checkpoint is the
full run's wherever validation peaks within the cut, since epochs run the
same whatever the stop epoch). Rows go under the JAX key names
(digits_real_laplace_probe_{S}shot_{ours,sklearn,gp}_{acc,ci95},
_gram_offdiag, _protocol), with the port's own
digits_real_laplace_probe_{S}shot_sklearn_float64 (arm (b) fitted in
float64), to --report (digits_report.json beside this file) with the
card's name and power limit, beside the JAX rows (JAX_ROWS). Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import numpy as np
import torch

from ._timing import card_of, merge_report
from .digits_real import REPORT, make_digits_filelists
from .dkt_sweep import checkpoint_epochs, cli, default_ckdir
from .sklearn_gpc import GaussianProcessClassifier

N_WAY, N_QUERY = 5, 15
SEED = 7  # the episodes' draw (JAX laplace_probe.py:37)
# the JAX package's rows (benchmarks/report.json:204-218)
JAX_ROWS = {
    "digits_real_laplace_probe_1shot_ours_acc": 54.97,
    "digits_real_laplace_probe_1shot_ours_ci95": 1.57,
    "digits_real_laplace_probe_1shot_sklearn_acc": 54.16,
    "digits_real_laplace_probe_1shot_sklearn_ci95": 1.57,
    "digits_real_laplace_probe_1shot_gp_acc": 57.97,
    "digits_real_laplace_probe_1shot_gp_ci95": 1.6,
    "digits_real_laplace_probe_1shot_gram_offdiag": 0.0001546,
    "digits_real_laplace_probe_5shot_ours_acc": 67.19,
    "digits_real_laplace_probe_5shot_ours_ci95": 0.98,
    "digits_real_laplace_probe_5shot_sklearn_acc": 66.99,
    "digits_real_laplace_probe_5shot_sklearn_ci95": 0.99,
    "digits_real_laplace_probe_5shot_gp_acc": 74.72,
    "digits_real_laplace_probe_5shot_gp_ci95": 0.99,
    "digits_real_laplace_probe_5shot_gram_offdiag": 0.002942,
}
PROTOCOL = (
    "same checkpoint + same episodes through (a) gp/laplace.py, (b) the "
    "reference's literal sklearn GaussianProcessClassifier 1.0*RBF(0.1) "
    "head (reference methods/DKT.py:207-222; here the port's float64 copy, "
    "benchmarks/sklearn_gpc.py), (c) the learned-kernel GP posterior; "
    "gram_offdiag = mean off-diagonal support Gram under RBF(0.1) "
    "documenting the identity collapse")


def mean_ci(values) -> tuple[float, float]:
    """(mean, 1.96 std / sqrt(n)), rounded to 2 places as the JAX rows."""
    v = np.asarray(values, np.float64)
    return (round(float(v.mean()), 2),
            round(float(1.96 * v.std() / np.sqrt(len(v))), 2))


@torch.no_grad()
def episode_arms(model, x: torch.Tensor, shot: int) -> dict:
    """The three arms' query accuracies (percent) and the support Gram's
    mean off-diagonal for one episode x [n_way, S+Q, H, W, C]."""
    from ..gp.laplace import laplace_ovr_predict, rbf_gram
    from ..methods.base import episode_labels, flatten_episode

    dev = model.device
    x = x.to(dev)
    n_way = x.shape[0]
    z_all, _ = model._features(flatten_episode(x))
    d = z_all.shape[-1]
    z = z_all.reshape(n_way, shot + N_QUERY, d)
    z_support = z[:, :shot].reshape(n_way * shot, d)
    z_query = z[:, shot:].reshape(-1, d)
    y_support = episode_labels(n_way, shot, dev)
    y_query = episode_labels(n_way, N_QUERY, dev)
    ours = laplace_ovr_predict(z_support, y_support, z_query, n_way)
    gpc = GaussianProcessClassifier().fit(
        z_support.double().cpu().numpy(), y_support.cpu().numpy())
    sk = gpc.predict(z_query.double().cpu().numpy())
    gp = torch.argmax(model.episode_scores(x), dim=-1)
    # the mean off the diagonal as the JAX probe takes it: the f32 Gram's
    # sum on the host, less its trace
    g = rbf_gram(z_support, z_support).cpu().numpy()
    n = g.shape[0]
    y_np = y_query.cpu().numpy()
    return {"ours": float((ours == y_query).float().mean()) * 100.0,
            "sklearn": float(np.mean(sk == y_np)) * 100.0,
            "gp": float((gp == y_query).float().mean()) * 100.0,
            "offdiag": float((g.sum() - np.trace(g)) / (n * n - n)),
            "sklearn_float64": all(e.x_train.dtype == np.float64
                                   for e in gpc.estimators_)}


def probe_rows(model, episodes, shot: int) -> dict:
    """The JAX probe's rows for one shot over `episodes`, an iterable of
    [1, n_way, S+Q, H, W, C] uint8 batches, and the port's own row
    `..._sklearn_float64`: whether every arm-(b) fit took float64."""
    arms = [episode_arms(model, torch.as_tensor(xb[0]), shot)
            for xb in episodes]
    pre = f"digits_real_laplace_probe_{shot}shot"
    rows = {}
    for arm in ("ours", "sklearn", "gp"):
        acc, ci = mean_ci([a[arm] for a in arms])
        rows[f"{pre}_{arm}_acc"], rows[f"{pre}_{arm}_ci95"] = acc, ci
    rows[f"{pre}_gram_offdiag"] = float(np.format_float_scientific(
        np.mean([a["offdiag"] for a in arms]), 3))
    rows[f"{pre}_sklearn_float64"] = all(a["sklearn_float64"] for a in arms)
    return rows


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--episodes", type=int, default=100)
    ap.add_argument("--shots", default="1,5")
    ap.add_argument("--epochs", type=int, default=-1,
                    help="stop epoch of a default run trained here")
    ap.add_argument("--root", default=None,
                    help="working directory (default: a temporary one)")
    ap.add_argument("--report", default=REPORT)
    args = ap.parse_args(argv)

    from .. import factory, train
    from .._device import resolve_device
    from ..data.filelist import EpisodicDataLoader
    from ..io_utils import parse_args
    from ..test import load_model

    device = resolve_device(device)
    report = os.path.abspath(args.report)
    card = card_of(device)
    merge_report(report, {"digits_real_laplace_probe_card": card,
                          "digits_real_laplace_probe_jax_rows": JAX_ROWS})
    rows: dict = {}
    cwd = os.getcwd()
    workdir = (contextlib.nullcontext(args.root) if args.root
               else tempfile.TemporaryDirectory())
    with workdir as root:
        root = os.path.abspath(root)
        make_digits_filelists(root)
        os.chdir(root)
        try:
            for shot in (int(s) for s in args.shots.split(",") if s):
                if not checkpoint_epochs(default_ckdir(shot)):
                    stop = ([f"--stop_epoch={args.epochs}"]
                            if args.epochs != -1 else [])
                    train.main(cli(shot, stop), device=device)
                params = parse_args("test", cli(shot, []))
                model = load_model(params, params.seed, device)
                image_size = factory.resolve_image_size(params)
                loader = EpisodicDataLoader(
                    factory.resolve_data_files(params,
                                               split_for_test="novel"),
                    image_size, N_WAY, shot, N_QUERY,
                    n_episodes=args.episodes, episode_batch=1, aug=False,
                    seed=SEED)
                shot_rows = probe_rows(model, loader, shot)
                rows.update(shot_rows)
                merge_report(report, shot_rows)
                pre = f"digits_real_laplace_probe_{shot}shot"
                print(f"{shot}-shot over {args.episodes} episodes: ours "
                      f"{rows[pre + '_ours_acc']}+-{rows[pre + '_ours_ci95']}"
                      f" | sklearn {rows[pre + '_sklearn_acc']}+-"
                      f"{rows[pre + '_sklearn_ci95']} | learned-GP "
                      f"{rows[pre + '_gp_acc']}+-{rows[pre + '_gp_ci95']} | "
                      f"offdiag {rows[pre + '_gram_offdiag']:.3e} | arm (b) "
                      f"float64, sklearn loaded: {'sklearn' in sys.modules}"
                      f" [{card}]", flush=True)
        finally:
            os.chdir(cwd)
    rows["digits_real_laplace_probe_protocol"] = PROTOCOL
    merge_report(report, {"digits_real_laplace_probe_protocol": PROTOCOL})
    return rows


if __name__ == "__main__":
    main()
