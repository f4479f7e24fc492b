"""Calibration CLI:

    python -m deep_kernel_transfer_tpu_torch.test_uncertainty \\
        --dataset=omniglot --model=Conv4 --method=DKT --n_shot=5 \\
        --repeat=3 --episode_batch=32

Port of the JAX package's test_uncertainty.py (reference
test_uncertainty.py:62-94, 105-263). Phase 1 collects the logits of
--n_iter episodes (n_query = 15) and fits a scalar temperature on their
NLL. Phase 2 collects --repeat reseeded runs and gives the 15-bin ECE raw
(T = 1) and calibrated. DKT (its posterior means, the GP conditioned on
each support set, one-vs-rest logits turned into sigmoid-normalised
probabilities, reference :78-81) and MAML (--adaptation: 100 inner steps)
collect from images; every other method from the save_features cache
(JAX test_uncertainty.py:150-173): scores_from_features, or a fresh
linear-probe head finetuned on each episode for the baselines.
Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from . import factory
from ._device import resolve_device
from .data.device_dataset import cached_dataset
from .data.feature_cache import init_loader, sample_feature_episode
from .data.filelist import EpisodicDataLoader
from .io_utils import parse_args
from .save_features import feature_file_path
from .test import (FROM_IMAGES, N_QUERY, check_maml_ways, feature_layout,
                   feature_scorer, load_model)
from .train import _set_seed
from .utils.metrics import calibrate_temperature, ece


def get_logits_targets_images(params, model, seed: int, device):
    """(logits [episodes * n_way * Q, n_way], labels) of --n_iter episodes
    drawn from `seed` (JAX test_uncertainty.py:45-82)."""
    _set_seed(seed)
    n_way, n_support = params.test_n_way, params.n_shot
    image_size = factory.resolve_image_size(params)
    novel_file = factory.resolve_data_files(params,
                                            split_for_test=params.split)
    episode_batch = max(params.episode_batch, 1)
    if factory.use_device_data(params, novel_file, image_size):
        loader = cached_dataset(novel_file, image_size, device=device,
                                verbose=True).epoch(
            seed, n_way, n_support, N_QUERY, n_episodes=params.n_iter,
            episode_batch=episode_batch)
    else:
        loader = (torch.from_numpy(xb) for xb in EpisodicDataLoader(
            novel_file, image_size, n_way, n_support, N_QUERY,
            n_episodes=params.n_iter, episode_batch=episode_batch, aug=False,
            seed=seed))
    # the logits stay on the device until the collection ends
    logits_of = getattr(model, "batch_logits", None) or model.batch_scores
    with torch.no_grad():
        outs = [logits_of(xb) for xb in loader]
    logits = torch.cat([o.reshape(-1, o.shape[-1]) for o in outs])
    n_episodes = sum(int(o.shape[0]) for o in outs)
    y = np.repeat(np.arange(n_way), N_QUERY)
    return logits.cpu().numpy(), np.tile(y, n_episodes)


def get_logits_targets_features(params, score, cl_data, to_port,
                                seed: int, device):
    """(logits, labels) of --n_iter episodes of the feature cache, all
    drawn from one RandomState(seed) and scored --episode_batch at a time
    (JAX test_uncertainty.py:85-108)."""
    rng = np.random.RandomState(seed)
    n_way, n_support = params.test_n_way, params.n_shot
    eb = max(params.episode_batch, 1)
    gen = torch.Generator(device=device).manual_seed(seed)
    outs, done = [], 0
    while done < params.n_iter:
        b = min(eb, params.n_iter - done)
        z = np.stack([sample_feature_episode(cl_data, rng, n_way, n_support,
                                             N_QUERY) for _ in range(b)])
        with torch.no_grad():
            outs.append(score(torch.from_numpy(to_port(z)).to(device), gen))
        done += b
    logits = torch.cat([o.reshape(-1, o.shape[-1]) for o in outs])
    y = np.repeat(np.arange(n_way), N_QUERY)
    return logits.cpu().numpy(), np.tile(y, done)


def make_collector(params, device):
    """collect(seed) -> (logits, labels) for the CLI's method."""
    check_maml_ways(params)
    if params.method in FROM_IMAGES:
        model = load_model(params, params.seed, device)
        return lambda seed: get_logits_targets_images(params, model, seed,
                                                      device)
    factory.check_model_constraints(params)
    cl_data = init_loader(feature_file_path(params))
    model = (None if params.method in ("baseline", "baseline++")
             else load_model(params, params.seed, device))
    score, to_port = feature_scorer(model, params), feature_layout(params)
    return lambda seed: get_logits_targets_features(
        params, score, cl_data, to_port, seed, device)


def main(argv=None, device=None) -> dict:
    """{ece_raw, ece_raw_std, ece_cal, ece_cal_std, temperature, acc}:
    means and standard deviations over the --repeat reseeded runs (JAX
    test_uncertainty.py:185-235)."""
    params = parse_args("test", argv)
    device = resolve_device(device)  # --n_devices is not read, as in JAX
    collect = make_collector(params, device)
    one_vs_rest = params.method == "DKT"

    # phase 1: the temperature, on a held-out collection
    logits, targets = collect(params.seed)
    temperature = calibrate_temperature(logits, targets)
    print(f"fitted temperature: {temperature:.4f}")

    # phase 2: reseeded runs, ECE before (T = 1) and after scaling
    eces_raw, eces_cal, accs = [], [], []
    for r in range(params.repeat):
        logits, targets = collect(params.seed + 1 + r)
        e_raw = ece(logits, targets, temperature=1.0,
                    one_vs_rest=one_vs_rest)
        e_cal = ece(logits, targets, temperature=temperature,
                    one_vs_rest=one_vs_rest)
        acc = float(np.mean(np.argmax(logits, 1) == targets)) * 100
        print(f"run {r}: ECE = {e_raw:.4f} raw / {e_cal:.4f} calibrated "
              f"| acc = {acc:.2f}%", flush=True)
        eces_raw.append(e_raw)
        eces_cal.append(e_cal)
        accs.append(acc)
    print("-----------------------------")
    print(f"ECE raw = {np.mean(eces_raw):.4f} +- {np.std(eces_raw):.4f} | "
          f"ECE calibrated = {np.mean(eces_cal):.4f} +- "
          f"{np.std(eces_cal):.4f} (T = {temperature:.3f})")
    print("-----------------------------")
    return {"ece_raw": float(np.mean(eces_raw)),
            "ece_raw_std": float(np.std(eces_raw)),
            "ece_cal": float(np.mean(eces_cal)),
            "ece_cal_std": float(np.std(eces_cal)),
            "temperature": float(temperature),
            "acc": float(np.mean(accs))}


if __name__ == "__main__":
    main()
