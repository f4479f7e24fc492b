"""Classification training CLI:

    python -m deep_kernel_transfer_tpu_torch.train --dataset=miniImagenet \\
        --model=Conv4 --method=DKT --train_aug --episode_batch=32

Port of the JAX package's train.py:57-376 (reference train.py:24-219):
the same flags, dataset, image-size and epoch rules, checkpoint directory
and best-model choice, for every classification method.

  * baseline / baseline++ (`train_baseline`): flat minibatches of 16 over
    the base split's classes from the host loader, no validation, the last
    model is the best.
  * every episodic method (`train_meta`): episodes from the splits staged
    in device memory (--device_data, sampled and, with --train_aug,
    augmented on the card) or streamed from the host loader; validation on
    the val split each epoch; best_model.tar at the first epoch that beats
    all earlier ones. MAML takes n_task episodes a step and n_task times
    the epochs (reference train.py:163-167). DKT starts each epoch with a
    fresh Adam (reset_opt_state) and logs its GP telemetry every 10
    batches. --warmup starts the trunk from the baseline's checkpoint.

Episode parallelism (JAX train.py:126-139,200-226): with --n_devices=N
(or by default over every GPU when there are several and the episode
batch divides), `main` starts N ranks, itself rank 0, or joins the
torchrun group it runs in (`torchrun --nproc_per_node=N -m
deep_kernel_transfer_tpu_torch.train --n_devices=N ...`). Each rank trains
on its slice of every episode batch (parallel/mesh.py); rank 0 alone
prints and writes the checkpoints and logs.

Checkpoints are in the reference's torch layout. Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU (over gloo for N ranks).
"""
from __future__ import annotations

import contextlib
import os
import random
from types import SimpleNamespace

import numpy as np
import torch

from . import configs, factory
from ._device import resolve_device
from .data.device_dataset import (cached_dataset, fused_protocol_accs,
                                  make_fused_epoch, make_fused_eval)
from .data.filelist import EpisodicDataLoader, SimpleDataLoader
from .io_utils import parse_args
from .methods import MAML
from .parallel.mesh import (in_group, make_sharded_eval,
                            make_sharded_train_step, rank_device,
                            replicate_tree,
                            shard_episode_batch, spawn_ranks,
                            wrap_pad_episodes)
from .utils.checkpoint import (get_resume_file, load_checkpoint,
                               save_checkpoint, warmup_from_baseline)
from .utils.logger import MetricsLogger
from .utils.profiling import trace

PRINT_FREQ = 10


def _set_seed(seed: int) -> None:
    """reference train.py:24-35."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def _resume(params, model, ckpt_dir, image_size) -> int:
    """The first epoch to run: after the latest <epoch>.tar with
    --resume."""
    if params.resume:
        resume_file = get_resume_file(ckpt_dir)
        if resume_file is not None:
            epoch = load_checkpoint(resume_file, model, image_size)
            print(f"resumed from {resume_file} (epoch {epoch})")
            return epoch + 1
    return params.start_epoch


def train_baseline(params, base_file, image_size, stop_epoch, ckpt_dir,
                   device):
    """Softmax or cosine pretraining over the base classes (reference
    train.py:37-67, baselinetrain.py:31-43; JAX train.py:57-106)."""
    loader = SimpleDataLoader(base_file, image_size, batch_size=16,
                              aug=params.train_aug, seed=params.seed)
    model = factory.build_method(params, params.train_n_way, params.n_shot,
                                 device)
    x0, _ = next(iter(loader))  # the JAX package's first draw, for its shape
    model.init(torch.from_numpy(x0),
               torch.Generator().manual_seed(params.seed))
    start_epoch = _resume(params, model, ckpt_dir, image_size)
    for epoch in range(start_epoch, stop_epoch):
        profiling = params.profile_dir and epoch == start_epoch
        total, i = 0.0, 0
        with (trace(params.profile_dir, device) if profiling
              else contextlib.nullcontext()):
            for x, y in loader:
                m = model.train_step(torch.from_numpy(x), torch.from_numpy(y))
                total = total + m["loss"]
                i += 1
                if i % PRINT_FREQ == 0:
                    print(f"Epoch {epoch} | Batch {i}/{len(loader)} | Loss "
                          f"{float(total) / i:.6f}", flush=True)
        # no validation protocol (reference baselinetrain.py:51)
        if epoch % params.save_freq == 0 or epoch == stop_epoch - 1:
            save_checkpoint(os.path.join(ckpt_dir, f"{epoch}.tar"), model,
                            epoch)
    # the last model is the best one (test's get_best_file)
    save_checkpoint(os.path.join(ckpt_dir, "best_model.tar"), model,
                    stop_epoch - 1)
    return model


def _episode_batch(params, model) -> int:
    """n_task episodes a step for MAML (reference train.py:163-167; JAX
    train.py:115-121), else --episode_batch."""
    return model.n_task if isinstance(model, MAML) else params.episode_batch


def _null_logger():
    """The logger of a rank that writes nothing (not rank 0)."""
    return SimpleNamespace(log_scalars=lambda *a, **k: None,
                           log_histogram=lambda *a, **k: None,
                           close=lambda: None)


def train_meta(params, base_file, val_file, image_size, stop_epoch, ckpt_dir,
               device):
    n_way, n_support = params.train_n_way, params.n_shot
    n_query = factory.train_n_query(params)
    test_way = params.test_n_way
    n_episodes = params.n_train_episodes
    model = factory.build_method(params, n_way, n_support, device)
    episode_batch = _episode_batch(params, model)
    if isinstance(model, MAML):
        stop_epoch = stop_epoch * model.n_task  # n_task times the epochs
    n_batches = -(-n_episodes // episode_batch)
    is_dkt = hasattr(model, "train_telemetry")
    mesh = factory.resolve_mesh(params, model, episode_batch, device)
    lead = mesh is None or mesh.rank == 0  # prints and writes files
    if mesh is None:
        step, correct = model.train_step, model.batch_correct
    else:
        device = mesh.device
        step = make_sharded_train_step(model, mesh)
        correct = make_sharded_eval(model, mesh)
        if lead:
            print(f"episode-parallel mesh: {mesh.shape} ({mesh.device.type}"
                  f", {mesh.size} ranks)", flush=True)

    fused_chunk = fused_val = None
    if factory.use_device_data(params, base_file, image_size,
                               canvas=params.train_aug):
        # both splits in device memory: episodes are drawn (and augmented)
        # on the card, and the host moves no pixels inside the loop; with
        # a mesh each rank keeps its rows of every batch
        base_ds = cached_dataset(base_file, image_size, canvas=params.train_aug,
                                 device=device, verbose=lead)
        val_ds = cached_dataset(val_file, image_size, device=device,
                                verbose=lead)
        if mesh is not None:
            base_ds, val_ds = base_ds.shard(mesh), val_ds.shard(mesh)
        fused_chunk = make_fused_epoch(
            model, base_ds, n_way, n_support, n_query, episode_batch,
            augment_to=image_size if params.train_aug else None, step=step)
        fused_val = make_fused_eval(model, val_ds, test_way, n_support,
                                    n_query, episode_batch, correct)
    else:
        # with a mesh every rank runs the same loader and keeps its slice
        base_loader = EpisodicDataLoader(
            base_file, image_size, n_way, n_support, n_query,
            n_episodes=n_episodes, episode_batch=episode_batch,
            aug=params.train_aug, seed=params.seed)
        val_loader = EpisodicDataLoader(
            val_file, image_size, test_way, n_support, n_query,
            n_episodes=n_episodes, episode_batch=episode_batch, aug=False,
            seed=params.seed + 1)

    def host_batch(fn, xb):
        """fn of a host loader's global batch: of this rank's slice with
        a mesh (the batch padded by wrapping, the output trimmed)."""
        if mesh is None:
            return fn(xb.to(device))
        xb, _ = wrap_pad_episodes(xb, mesh)
        return fn(shard_episode_batch(xb, mesh))

    example = torch.zeros((n_way, n_support + n_query, image_size, image_size,
                           3), dtype=torch.uint8)
    model.init(example, torch.Generator().manual_seed(params.seed))

    start_epoch = _resume(params, model, ckpt_dir, image_size)
    if not params.resume and params.warmup:
        # reference train.py:198-201: <model>_baseline[_aug], no way/shot
        warmup_from_baseline(os.path.join(
            configs.save_dir, "checkpoints", params.dataset,
            f"{params.model}_baseline" + ("_aug" if params.train_aug else "")),
            model)

    if mesh is not None:
        # every rank starts from rank 0's parameters, buffers and optimizer
        # state (the JAX replicate_tree of the state); the averaged steps
        # keep them equal
        replicate_tree([model, model.optimizer], mesh)
    logger = (MetricsLogger(os.path.join(ckpt_dir, "log")) if lead
              else _null_logger())
    max_acc = 0.0
    for epoch in range(start_epoch, stop_epoch):
        if is_dkt:
            model.reset_opt_state()  # reference DKT.py:114-115
        # losses stay on the device between print boundaries: reading one
        # back every step would make the host wait for the card each time
        losses, extra, last_m, i = [], {}, None, 0

        def print_progress(m, xb):
            nonlocal extra
            extra = {k: float(v) for k, v in m.items() if k != "loss"}
            avg_loss = float(torch.cat(losses).mean())
            if not lead:
                return
            if not is_dkt:
                print(f"Epoch {epoch} | Batch {i}/{n_batches} | Loss "
                      f"{avg_loss:.6f}", flush=True)
                return
            # with a mesh: the loss averaged over the ranks, the telemetry
            # of rank 0's episodes
            tele = model.train_telemetry(xb)
            acc_s = float(tele["GP_support_accuracy"])
            acc_q = float(tele["GP_query_accuracy"])
            it = epoch * n_batches + i
            logger.log_scalars(it, loss=float(m["loss"]),
                               GP_support_accuracy=acc_s,
                               GP_query_accuracy=acc_q, **extra)
            logger.log_histogram(it, "z_support",
                                 tele["z_support"].cpu().numpy())
            hyp = " | ".join(f"{k.capitalize()} {v:f}" for k, v in extra.items())
            print(f"Epoch {epoch} | Batch {i}/{n_batches} | Loss "
                  f"{avg_loss:.6f} | {hyp} | Supp. {acc_s:.2f} | Query "
                  f"{acc_q:.2f}", flush=True)

        profiling = params.profile_dir and epoch == start_epoch and lead
        with (trace(params.profile_dir, device) if profiling
              else contextlib.nullcontext()):
            if fused_chunk is not None:
                # full batches in chunks of PRINT_FREQ steps, then the
                # remainder as one smaller batch, as the host loader does
                gen = base_ds.generator(params.seed * 100003 + epoch)
                nb_full, rem = divmod(n_episodes, episode_batch)
                chunks = [(min(PRINT_FREQ, nb_full - j), episode_batch)
                          for j in range(0, nb_full, PRINT_FREQ)]
                for ln, b in chunks + ([(1, rem)] if rem else []):
                    ms, xb = fused_chunk(gen, ln, b)
                    losses.append(ms["loss"])
                    i += ln
                    last_m = {k: v[-1] for k, v in ms.items()}
                    if i % PRINT_FREQ == 0:
                        print_progress(last_m, xb)
            else:
                for xb in base_loader:
                    m = host_batch(step, torch.from_numpy(xb))
                    losses.append(m["loss"][None])
                    i += 1
                    last_m = m
                    if i % PRINT_FREQ == 0:
                        print_progress(m, torch.from_numpy(xb))
        if profiling:
            print(f"profile trace written to {params.profile_dir}")
        if last_m is not None:
            extra = {k: float(v) for k, v in last_m.items() if k != "loss"}
        epoch_loss = float(torch.cat(losses).mean()) if losses else 0.0

        if fused_val is not None:
            accs = fused_protocol_accs(
                fused_val, val_ds.generator(params.seed * 100003 + 50001
                                            + epoch),
                n_episodes, episode_batch)
        else:
            accs = torch.cat([host_batch(correct, torch.from_numpy(xb))
                              [:xb.shape[0]] for xb in val_loader])
        acc = float(accs.mean())
        if lead:
            print(f"Epoch {epoch} | Val acc {acc:.2f}%", flush=True)
        logger.log_scalars(epoch, epoch_loss=epoch_loss, test_accuracy=acc,
                           **extra)
        if acc > max_acc:  # reference train.py:57-60
            max_acc = acc
            if lead:
                save_checkpoint(os.path.join(ckpt_dir, "best_model.tar"),
                                model, epoch)
                print("best model! save...")
        if lead and (epoch % params.save_freq == 0
                     or epoch == stop_epoch - 1):
            save_checkpoint(os.path.join(ckpt_dir, f"{epoch}.tar"), model,
                            epoch)
    logger.close()
    return model


def main(argv=None, device=None):
    """Parse the flags and train; returns the trained model (rank 0's).
    `device` None means CUDA (raising without a CUDA device). Where the
    run takes N > 1 episode-parallel ranks and no group is up yet, this
    process becomes rank 0 of N it starts (parallel.mesh.spawn_ranks)."""
    params = parse_args("train", argv)
    device = resolve_device(device)
    if params.method not in ("baseline", "baseline++") and not in_group():
        probe = factory.build_method(params, params.train_n_way,
                                     params.n_shot, device)
        n = factory.mesh_size(params, probe, _episode_batch(params, probe),
                              device)
        if n > 1:
            return spawn_ranks(n, device, run, params, device)
    return run(params, device)


def run(params, device):
    """Train with parsed flags on `device` (one rank's part where a group
    is up)."""
    device = rank_device(device)
    _set_seed(params.seed)

    base_file, val_file = factory.resolve_data_files(params)
    image_size = factory.resolve_image_size(params)
    factory.check_model_constraints(params)
    stop_epoch = (params.stop_epoch if params.stop_epoch != -1
                  else factory.default_stop_epoch(params))
    ckpt_dir = factory.checkpoint_dir(params)
    os.makedirs(ckpt_dir, exist_ok=True)
    print(f"checkpoint dir: {ckpt_dir} | epochs: {stop_epoch} | device: "
          f"{device}")
    if params.method in ("baseline", "baseline++"):
        return train_baseline(params, base_file, image_size, stop_epoch,
                              ckpt_dir, device)
    return train_meta(params, base_file, val_file, image_size, stop_epoch,
                      ckpt_dir, device)


if __name__ == "__main__":
    main()
