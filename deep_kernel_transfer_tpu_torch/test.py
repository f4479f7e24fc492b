"""DKT evaluation CLI:

    python -m deep_kernel_transfer_tpu_torch.test --dataset=miniImagenet \\
        --model=Conv4 --method=DKT --train_aug --episode_batch=32

Port of the from-images DKT path of the JAX package's test.py:86-206 and
:238-272 (reference test.py): --n_iter (600) episodes of n_query = 15 from
the test split, the GP conditioned on each episode's support set,
accuracy mean +- 1.96 std / sqrt(n); --repeat reseeded runs averaged; the
result appended to record/results.txt. Episodes come from the split staged
in device memory (--device_data) or from the host loader, which draws the
JAX package's episodes for the same seed. DKT's test-time heads (JAX
test.py:128-133,186-196): --laplace scores with the Laplace GP classifier,
--adaptation adapts each episode's GP hyperparameters for 100 Adam steps
on its support set first. The feature-cache methods wait for ROADMAP
queue A, item 7. Runs on CUDA; `main(argv, device="cpu")` runs on the
CPU.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import factory
from ._device import resolve_device
from .data.device_dataset import (cached_dataset, fused_protocol_accs,
                                  make_fused_eval)
from .data.filelist import EpisodicDataLoader
from .io_utils import parse_args
from .methods.base import ci95
from .train import _set_seed
from .utils.checkpoint import load_checkpoint, resolve_checkpoint_file

N_QUERY = 15  # reference test.py:142
ADAPTATION_STEPS = 100  # JAX test.py:196


def episode_scorer(model, params):
    """The batch -> per-episode accuracy% function of the chosen head."""
    if params.laplace:
        return model.batch_correct_laplace
    if params.adaptation:
        return lambda xb: model.batch_correct_adapted(
            xb, steps=ADAPTATION_STEPS)
    return model.batch_correct


def load_model(params, seed: int, device):
    """The method at the TRAIN n_way (the checkpoint's per-way GPs; fewer
    test ways use the first ones, change_way), initialised from `seed` and
    loaded from the chosen checkpoint when there is one."""
    image_size = factory.resolve_image_size(params)
    factory.check_model_constraints(params)
    model = factory.build_method(params, params.train_n_way, params.n_shot,
                                 device)
    ckpt_file = resolve_checkpoint_file(factory.checkpoint_dir(params),
                                        params.save_iter)
    example = torch.zeros((params.train_n_way, params.n_shot + N_QUERY,
                           image_size, image_size, 3), dtype=torch.uint8)
    model.init(example, torch.Generator().manual_seed(seed))
    if ckpt_file is not None:
        load_checkpoint(ckpt_file, model, image_size)
        print(f"loaded {ckpt_file}")
    return model


def single_test(params, seed: int, device) -> tuple[float, float]:
    """One evaluation run -> (accuracy %, its 95% half-width)."""
    _set_seed(seed)
    n_way, n_support = params.test_n_way, params.n_shot
    model = load_model(params, seed, device)
    image_size = factory.resolve_image_size(params)
    novel_file = factory.resolve_data_files(params,
                                            split_for_test=params.split)
    episode_batch = max(params.episode_batch, 1)
    correct = episode_scorer(model, params)

    if factory.use_device_data(params, novel_file, image_size):
        # the whole split in device memory, episodes drawn on the card:
        # accuracies stay there until the protocol ends
        ds = cached_dataset(novel_file, image_size, device=device,
                            verbose=True)
        accs = fused_protocol_accs(
            make_fused_eval(model, ds, n_way, n_support, N_QUERY,
                            episode_batch, correct),
            ds.generator(seed), params.n_iter, episode_batch)
    else:
        loader = EpisodicDataLoader(
            novel_file, image_size, n_way, n_support, N_QUERY,
            n_episodes=params.n_iter, episode_batch=episode_batch, aug=False,
            seed=seed)
        accs = torch.cat([correct(torch.from_numpy(xb)) for xb in loader])
    accs = accs.cpu().numpy()
    return float(accs.mean()), ci95(accs)


def main(argv=None, device=None, return_runs: bool = False):
    """The --repeat reseeded protocol. Returns (acc, ci), ci the mean of
    the runs' episode-level 95% half-widths (reference test.py:174), and
    with return_runs the runs' accuracies as a third item (JAX
    test.py:238-276)."""
    params = parse_args("test", argv)
    if params.method != "DKT":
        raise NotImplementedError(
            f"method '{params.method}' is not ported yet (ROADMAP queue A, "
            "item 7)")
    factory.check_devices(params)
    device = resolve_device(device)
    accs, cis = [], []
    for r in range(params.repeat):
        acc, ci = single_test(params, seed=params.seed + r, device=device)
        print(f"run {r}: {params.n_iter} episodes, acc = {acc:.2f}% +- "
              f"{ci:.2f}%", flush=True)
        accs.append(acc)
        cis.append(ci)
    acc, ci = float(np.mean(accs)), float(np.mean(cis))
    print("-----------------------------")
    print(f"Seeds = {params.repeat} | Overall Test Acc = {acc:.2f}% +- "
          f"{ci:.2f}%")
    print("-----------------------------")

    # record/results.txt (reference test.py:175-184)
    os.makedirs("./record", exist_ok=True)
    with open("./record/results.txt", "a") as f:
        timestamp = time.strftime("%Y%m%d-%H%M%S", time.localtime())
        aug_str = "-aug" if params.train_aug else ""
        aug_str += "-adapted" if params.adaptation else ""
        exp_setting = (f"{params.dataset}-{params.model}-{params.method}"
                       f"{aug_str} {params.n_shot}shot "
                       f"{params.test_n_way}way_test")
        acc_str = f"{params.repeat} Test Acc = {acc:.2f}% +- {ci:.2f}%"
        f.write(f"Time: {timestamp}, Setting: {exp_setting}, Acc: "
                f"{acc_str}\n")
    if return_runs:
        return acc, ci, accs
    return acc, ci


if __name__ == "__main__":
    main()
