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

Checkpoints are in the reference's torch layout. Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""
from __future__ import annotations

import contextlib
import os
import random

import numpy as np
import torch

from . import configs, factory
from ._device import resolve_device
from .data.device_dataset import (cached_dataset, fused_protocol_accs,
                                  make_fused_epoch, make_fused_eval)
from .data.filelist import EpisodicDataLoader, SimpleDataLoader
from .io_utils import parse_args
from .methods import MAML
from .utils.checkpoint import (get_resume_file, load_checkpoint,
                               save_checkpoint, warmup_from_baseline)
from .utils.logger import MetricsLogger

PRINT_FREQ = 10


def _set_seed(seed: int) -> None:
    """reference train.py:24-35."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def _profile(profile_dir: str, device: torch.device):
    """A torch.profiler trace of the block, written to profile_dir."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


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
        with (_profile(params.profile_dir, device) if profiling
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


def train_meta(params, base_file, val_file, image_size, stop_epoch, ckpt_dir,
               device):
    n_way, n_support = params.train_n_way, params.n_shot
    n_query = factory.train_n_query(params)
    test_way = params.test_n_way
    episode_batch = params.episode_batch
    n_episodes = params.n_train_episodes
    model = factory.build_method(params, n_way, n_support, device)
    if isinstance(model, MAML):
        # n_task episodes a step, and n_task times the epochs (reference
        # train.py:163-167; JAX train.py:115-121)
        episode_batch = model.n_task
        stop_epoch = stop_epoch * model.n_task
    n_batches = -(-n_episodes // episode_batch)
    is_dkt = hasattr(model, "train_telemetry")

    fused_chunk = fused_val = None
    if factory.use_device_data(params, base_file, image_size,
                               canvas=params.train_aug):
        # both splits in device memory: episodes are drawn (and augmented)
        # on the card, and the host moves no pixels inside the loop
        base_ds = cached_dataset(base_file, image_size, canvas=params.train_aug,
                                 device=device, verbose=True)
        val_ds = cached_dataset(val_file, image_size, device=device,
                                verbose=True)
        fused_chunk = make_fused_epoch(
            model, base_ds, n_way, n_support, n_query, episode_batch,
            augment_to=image_size if params.train_aug else None)
        fused_val = make_fused_eval(model, val_ds, test_way, n_support,
                                    n_query, episode_batch)
    else:
        base_loader = EpisodicDataLoader(
            base_file, image_size, n_way, n_support, n_query,
            n_episodes=n_episodes, episode_batch=episode_batch,
            aug=params.train_aug, seed=params.seed)
        val_loader = EpisodicDataLoader(
            val_file, image_size, test_way, n_support, n_query,
            n_episodes=n_episodes, episode_batch=episode_batch, aug=False,
            seed=params.seed + 1)

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

    logger = MetricsLogger(os.path.join(ckpt_dir, "log"))
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
            if not is_dkt:
                print(f"Epoch {epoch} | Batch {i}/{n_batches} | Loss "
                      f"{avg_loss:.6f}", flush=True)
                return
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

        profiling = params.profile_dir and epoch == start_epoch
        with (_profile(params.profile_dir, device) if profiling
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
                    m = model.train_step(torch.from_numpy(xb).to(device))
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
            accs = torch.cat([model.batch_correct(torch.from_numpy(xb))
                              for xb in val_loader])
        acc = float(accs.mean())
        print(f"Epoch {epoch} | Val acc {acc:.2f}%", flush=True)
        logger.log_scalars(epoch, epoch_loss=epoch_loss, test_accuracy=acc,
                           **extra)
        if acc > max_acc:  # reference train.py:57-60
            max_acc = acc
            save_checkpoint(os.path.join(ckpt_dir, "best_model.tar"), model,
                            epoch)
            print("best model! save...")
        if epoch % params.save_freq == 0 or epoch == stop_epoch - 1:
            save_checkpoint(os.path.join(ckpt_dir, f"{epoch}.tar"), model,
                            epoch)
    logger.close()
    return model


def main(argv=None, device=None):
    """Parse the flags and train; returns the trained model. `device`
    None means CUDA (raising without a CUDA device)."""
    params = parse_args("train", argv)
    factory.check_devices(params)
    device = resolve_device(device)
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
