"""Classification evaluation CLI:

    python -m deep_kernel_transfer_tpu_torch.test --dataset=miniImagenet \\
        --model=Conv4 --method=DKT --train_aug --episode_batch=32

Port of the JAX package's test.py:48-276 (reference test.py): --n_iter
(600) episodes of n_query = 15 from the test split, accuracy mean +- 1.96
std / sqrt(n); --repeat reseeded runs averaged; the result appended to
record/results.txt.

  * DKT and MAML score from images. Episodes come from the split staged in
    device memory (--device_data) or from the host loader, which draws the
    JAX package's episodes for the same seed. DKT's test-time heads (JAX
    test.py:128-133,186-196): --laplace scores with the Laplace GP
    classifier, --adaptation adapts each episode's GP hyperparameters for
    100 Adam steps on its support set first. MAML's --adaptation takes 100
    inner steps.
  * Every other method scores episodes of the save_features cache, drawn
    with the JAX package's numpy draws (`feature_evaluation`): the method's
    scores_from_features; RelationNet's relation-module finetune under
    --adaptation; the linear-probe finetune for the baselines and for the
    other methods under --adaptation. The episodes are scored
    FEATURE_BATCH at a time; the finetunes draw from a torch.Generator.

Episode parallelism (JAX test.py:135-165): the standard head from images
takes --n_devices ranks, or by default every GPU when there are several
and the episode batch divides; `main` starts them, itself rank 0, or joins
the torchrun group it runs in. Each rank scores its slice of every episode
batch and the accuracies are gathered; rank 0 alone prints and writes
record/results.txt. --laplace, --adaptation of DKT and the feature cache
run on one device.

Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from . import factory
from ._device import resolve_device
from .data.device_dataset import (cached_dataset, fused_protocol_accs,
                                  make_fused_eval)
from .data.feature_cache import init_loader, sample_feature_episode
from .data.filelist import EpisodicDataLoader
from .io_utils import parse_args
from .methods.base import ci95, query_accuracy
from .methods.baseline import finetune_scores
from .models.backbones import model_dict
from .parallel.mesh import (in_group, make_sharded_eval, rank_device,
                            replicate_tree, shard_episode_batch, spawn_ranks,
                            wrap_pad_episodes)
from .save_features import feature_file_path
from .train import _set_seed
from .utils.checkpoint import load_checkpoint, resolve_checkpoint_file
from .utils.convert import features_from_jax

N_QUERY = 15  # reference test.py:142
ADAPTATION_STEPS = 100  # JAX test.py:196
FROM_IMAGES = ("DKT", "maml", "maml_approx")
FEATURE_BATCH = 100  # feature episodes scored together


def special_head(params) -> bool:
    """DKT's --laplace or --adaptation: they run on one device."""
    return params.method == "DKT" and (params.laplace or params.adaptation)


def episode_scorer(model, params):
    """The batch -> per-episode accuracy% function of the chosen head."""
    if params.method == "DKT" and params.laplace:
        return model.batch_correct_laplace
    if params.method == "DKT" and params.adaptation:
        return lambda xb: model.batch_correct_adapted(
            xb, steps=ADAPTATION_STEPS)
    return model.batch_correct


def check_maml_ways(params) -> None:
    """MAML's head has train_n_way outputs (reference maml.py:13,
    change_way=False)."""
    if (params.method in ("maml", "maml_approx")
            and params.test_n_way != params.train_n_way):
        raise ValueError("maml does not support test_n_way != train_n_way "
                         "(reference change_way=False)")


def load_model(params, seed: int, device):
    """The method at the TRAIN n_way (the checkpoint's per-way GPs; fewer
    test ways use the first ones, change_way), initialised from `seed` and
    loaded from the chosen checkpoint when there is one."""
    image_size = factory.resolve_image_size(params)
    factory.check_model_constraints(params)
    model = factory.build_method(params, params.train_n_way, params.n_shot,
                                 device)
    if params.method in ("maml", "maml_approx") and params.adaptation:
        model.task_update_num = ADAPTATION_STEPS  # reference test.py:158-159
    ckpt_file = resolve_checkpoint_file(factory.checkpoint_dir(params),
                                        params.save_iter)
    example = torch.zeros((params.train_n_way, params.n_shot + N_QUERY,
                           image_size, image_size, 3), dtype=torch.uint8)
    model.init(example, torch.Generator().manual_seed(seed))
    if ckpt_file is not None:
        load_checkpoint(ckpt_file, model, image_size)
        print(f"loaded {ckpt_file}")
    return model


def feature_scorer(model, params):
    """score(z, generator) -> [E, n_way*Q, n_way] for feature episodes z
    [E, n_way, S+Q, ...] (JAX test.py:48-71)."""
    if params.adaptation and params.method in ("relationnet",
                                               "relationnet_softmax"):
        return model.adapted_scores_from_features
    if params.adaptation or params.method in ("baseline", "baseline++"):
        loss_type = "dist" if params.method == "baseline++" else "softmax"
        return lambda z, gen: finetune_scores(z, params.n_shot, loss_type,
                                              gen)
    return lambda z, gen: model.scores_from_features(z)


def feature_layout(params):
    """Feature episodes of the cache (JAX layout) -> the port's layout."""
    if params.method in ("relationnet", "relationnet_softmax"):
        return lambda z: features_from_jax(z, None, 0)
    trunk = model_dict[params.model]()
    size = factory.resolve_image_size(params)
    return lambda z: features_from_jax(z, trunk, size)


def feature_evaluation(cl_data, score, params, seed: int, device,
                       to_port=lambda z: z) -> np.ndarray:
    """Per-episode accuracy% [n_iter] of --n_iter episodes of the cache,
    episode i drawn from RandomState(seed * 10000 + i) as the JAX package
    draws it (test.py:74-83)."""
    n_way, n_support = params.test_n_way, params.n_shot
    gen = torch.Generator(device=device).manual_seed(seed)
    accs = []
    for j in range(0, params.n_iter, FEATURE_BATCH):
        z = np.stack([sample_feature_episode(
            cl_data, np.random.RandomState(seed * 10000 + i), n_way,
            n_support, N_QUERY)
            for i in range(j, min(j + FEATURE_BATCH, params.n_iter))])
        z = torch.from_numpy(to_port(z)).to(device)
        with torch.no_grad():
            accs.append(query_accuracy(torch.argmax(score(z, gen), dim=-1),
                                       n_way))
    return torch.cat(accs).cpu().numpy()


def single_test(params, seed: int, device) -> tuple[float, float]:
    """One evaluation run -> (accuracy %, its 95% half-width)."""
    _set_seed(seed)
    check_maml_ways(params)
    if params.method not in FROM_IMAGES:
        factory.check_model_constraints(params)
        cl_data = init_loader(feature_file_path(params))
        model = (None if params.method in ("baseline", "baseline++")
                 else load_model(params, seed, device))
        accs = feature_evaluation(cl_data, feature_scorer(model, params),
                                  params, seed, device,
                                  feature_layout(params))
        return float(accs.mean()), ci95(accs)
    n_way, n_support = params.test_n_way, params.n_shot
    model = load_model(params, seed, device)
    image_size = factory.resolve_image_size(params)
    novel_file = factory.resolve_data_files(params,
                                            split_for_test=params.split)
    episode_batch = max(params.episode_batch, 1)
    correct = episode_scorer(model, params)
    mesh = (None if special_head(params)
            else factory.resolve_mesh(params, model, episode_batch, device))
    if mesh is not None:
        replicate_tree(model, mesh)  # rank 0's weights on every rank
        correct = make_sharded_eval(model, mesh)

    if factory.use_device_data(params, novel_file, image_size):
        # the whole split in device memory, episodes drawn on the card:
        # accuracies stay there until the protocol ends
        ds = cached_dataset(novel_file, image_size, device=device,
                            verbose=mesh is None or mesh.rank == 0)
        if mesh is not None:
            ds = ds.shard(mesh)
        accs = fused_protocol_accs(
            make_fused_eval(model, ds, n_way, n_support, N_QUERY,
                            episode_batch, correct),
            ds.generator(seed), params.n_iter, episode_batch)
    else:
        loader = EpisodicDataLoader(
            novel_file, image_size, n_way, n_support, N_QUERY,
            n_episodes=params.n_iter, episode_batch=episode_batch, aug=False,
            seed=seed)
        accs = []
        for xb in loader:
            b = xb.shape[0]
            if mesh is not None:  # every rank decodes, each keeps its slice
                xb = shard_episode_batch(wrap_pad_episodes(xb, mesh)[0], mesh)
            accs.append(correct(torch.as_tensor(xb))[:b])
        accs = torch.cat(accs)
    accs = accs.cpu().numpy()
    return float(accs.mean()), ci95(accs)


def main(argv=None, device=None, return_runs: bool = False):
    """The --repeat reseeded protocol. Returns (acc, ci), ci the mean of
    the runs' episode-level 95% half-widths (reference test.py:174), and
    with return_runs the runs' accuracies as a third item (JAX
    test.py:238-276)."""
    params = parse_args("test", argv)
    device = resolve_device(device)
    if (params.method in FROM_IMAGES and not special_head(params)
            and not in_group()):
        probe = factory.build_method(params, params.train_n_way,
                                     params.n_shot, device)
        n = factory.mesh_size(params, probe, max(params.episode_batch, 1),
                              device)
        if n > 1:
            return spawn_ranks(n, device, run, params, device, return_runs)
    return run(params, device, return_runs)


def run(params, device, return_runs: bool = False):
    """main's protocol with parsed flags on `device` (one rank's part where
    a group is up; the ranks compute the same accuracies, rank 0 reports
    them)."""
    device = rank_device(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    accs, cis = [], []
    for r in range(params.repeat):
        acc, ci = single_test(params, seed=params.seed + r, device=device)
        if lead:
            print(f"run {r}: {params.n_iter} episodes, acc = {acc:.2f}% +- "
                  f"{ci:.2f}%", flush=True)
        accs.append(acc)
        cis.append(ci)
    acc, ci = float(np.mean(accs)), float(np.mean(cis))
    if not lead:
        return (acc, ci, accs) if return_runs else (acc, ci)
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
