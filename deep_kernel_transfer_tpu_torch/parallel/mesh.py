"""Episode-parallel training and eval over torch.distributed.

Port of the episode half of deep_kernel_transfer_tpu/parallel/mesh.py.
The JAX package shards the episode axis of a batch over a 1-D device mesh
and lets XLA insert the gradient psum. Here one process drives one device
(rank r on cuda:r; on the CPU, processes over gloo), every rank holds the
whole model, and each takes its own slice of the global episode batch:

  * `make_mesh` joins the process group (started by `spawn_ranks` or by
    torchrun) or, for one rank, starts it;
  * `replicate_tree` broadcasts parameters, buffers and optimizer state
    from rank 0, so every rank starts from rank 0's draws;
  * `make_sharded_train_step` runs methods/base.py::train_step_body with
    the gradients, the BatchNorm statistics and the loss averaged over the
    ranks before the update (the local batches are of equal size, so the
    mean of the ranks' means is the global mean: the JAX psum);
  * `make_sharded_eval` gathers the ranks' per-episode accuracies.

The backend is NCCL on the card and gloo on the CPU. Only broadcast and
all_reduce are used, which gloo also runs on CUDA tensors (two ranks on
one card, where NCCL refuses). The tensor-parallel half of the JAX module
(`make_mesh_2d`, `tensor_sharding_rules`) is not ported. Importing this
module starts no process group.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

DATA_AXIS = "dp"
TIMEOUT = datetime.timedelta(seconds=300)  # a collective waiting longer fails


@dataclass(frozen=True)
class Mesh:
    """This process's place in the episode-parallel group (the default
    process group): its rank, the number of ranks and its device."""
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        """The extent of each mesh axis, as a JAX mesh's `shape`."""
        return {DATA_AXIS: self.size}


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on localhost, for a process group's address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def in_group() -> bool:
    """True when this process is one rank of several already: a process
    group is up, or torchrun's environment names one."""
    return dist.is_initialized() or int(os.environ.get("WORLD_SIZE", 1)) > 1


def local_device_count(device: torch.device) -> int:
    """Devices one host offers ranks: its GPUs, or its CPU cores."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def rank_device(device: torch.device) -> torch.device:
    """This process's device: in a group (or torchrun's environment) on a
    CUDA device, cuda:LOCAL_RANK, made current; else `device`."""
    if device.type != "cuda" or not in_group():
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    device = torch.device("cuda", local)
    torch.cuda.set_device(device)
    return device


def _check_devices(local: int, device: torch.device, n_devices) -> None:
    """Raise when this host would run more ranks than it has devices."""
    available = local_device_count(device)
    if local > available:
        raise ValueError(
            f"make_mesh(n_devices={n_devices}): only {available} devices "
            f"available (silently truncating would run with less "
            f"parallelism than the per-device batch math assumes)")


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The episode-parallel mesh of this process: joins the process group
    that `spawn_ranks` or torchrun started (env://), or starts a group of
    one rank. `n_devices` None takes the group's size. Raises when the
    host has fewer devices than ranks, or the group another size."""
    device = resolve_device(device)
    _check_devices(int(os.environ.get("LOCAL_WORLD_SIZE", n_devices or 1)),
                   device, n_devices)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            dist.init_process_group(_backend(device), init_method="env://",
                                    timeout=TIMEOUT)
        elif n_devices in (None, 1):
            dist.init_process_group(
                _backend(device), init_method=f"tcp://localhost:{free_port()}",
                world_size=1, rank=0, timeout=TIMEOUT)
        else:
            raise RuntimeError(
                f"make_mesh(n_devices={n_devices}): no process group; start "
                f"the ranks with spawn_ranks or torchrun")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and size != n_devices:
        raise ValueError(f"make_mesh(n_devices={n_devices}): the process "
                         f"group has {size} ranks")
    return Mesh(rank, size, rank_device(device))


def _join(rank: int, n: int, init_method: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(_backend(device), init_method=init_method,
                            world_size=n, rank=rank, timeout=TIMEOUT)


def _rank_main(rank: int, n: int, init_method: str, device: torch.device,
               fn: Callable, args: tuple) -> None:
    _join(rank, n, init_method, device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(n: int, device, fn: Callable, *args):
    """fn(*args) on n ranks of one host: this process is rank 0, and n - 1
    processes started with `spawn` are the others (rank r on cuda:r).
    Returns rank 0's result; raises when a rank fails. fn must be
    importable by name (the workers unpickle it)."""
    device = torch.device(device)
    _check_devices(n, device, n)
    init_method = f"tcp://localhost:{free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init_method, device, fn, args))
             for r in range(1, n)]
    for p in procs:
        p.start()
    wait = 10.0  # the others cannot finish without rank 0
    try:
        _join(0, n, init_method, device)
        try:
            result = fn(*args)
            wait = TIMEOUT.total_seconds()
            return result
        finally:
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(wait)
            if p.is_alive():
                p.terminate()
                p.join()
        failed = [p.exitcode for p in procs if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"{len(failed)} of {n} ranks failed, exit "
                               f"codes {failed}")


def shard_episode_batch(xb, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the global episode batch [B, ...] (a tensor or
    a numpy array), on its device. B must divide by the episode axis's
    extent."""
    b, extent = xb.shape[0], mesh.shape[DATA_AXIS]
    if b % extent:
        raise ValueError(f"episode batch {b} does not divide over {extent} "
                         f"ranks (wrap_pad_episodes first)")
    k = b // extent
    part = xb[mesh.rank * k:(mesh.rank + 1) * k]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(mesh.device)


def distribute_local_episodes(xb_local, mesh: Mesh) -> torch.Tensor:
    """Each process's own [B_local, ...] episodes, loaded by itself, on its
    device: the global batch is their concatenation in rank order. The
    ranks' B_local must be equal (the means of the sharded step assume
    it)."""
    return torch.as_tensor(xb_local).to(mesh.device)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().values()
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            yield from _tensors(state)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@torch.no_grad()
def replicate_tree(tree, mesh: Mesh):
    """Every tensor of `tree` (a module's parameters and buffers, an
    optimizer's state, or dicts, lists and tuples of them) overwritten in
    place by rank 0's. Returns tree."""
    for t in _tensors(tree):
        buf = t if t.device == mesh.device else t.to(mesh.device)
        dist.broadcast(buf, 0)
        if buf is not t:
            t.copy_(buf)
    return tree


@torch.no_grad()
def average(tensors: list, mesh: Mesh) -> None:
    """Each floating tensor replaced in place by its mean over the ranks:
    one all_reduce a dtype, over the tensors laid end to end."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(mesh.device) for t in ts])
        dist.all_reduce(flat)
        flat /= mesh.size
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def make_sharded_train_step(method, mesh: Mesh):
    """step(xb_local) -> metrics: the method's train_step on this rank's
    episodes, the same train_step_body as one process runs, with the
    gradients, BatchNorm statistics and loss averaged over the ranks
    before the update (JAX mesh.py:83-119). Every rank must hold the same
    parameters first (replicate_tree)."""
    def step(xb_local: torch.Tensor) -> dict:
        return method.train_step(xb_local,
                                 average=lambda ts: average(ts, mesh))

    return step


def make_sharded_eval(method, mesh: Mesh):
    """eval(xb_local) -> per-episode accuracy% [n_ranks * B_local] of the
    global batch, on every rank: method.batch_correct on this rank's
    episodes, gathered in rank order (JAX mesh.py:143-154). The gather is
    an all_reduce of the rank's block into zeros, which is exact."""
    def eval_fn(xb_local: torch.Tensor) -> torch.Tensor:
        acc = method.batch_correct(xb_local).to(mesh.device)
        b = acc.shape[0]
        out = torch.zeros(mesh.size * b, dtype=acc.dtype, device=mesh.device)
        out[mesh.rank * b:(mesh.rank + 1) * b] = acc
        dist.all_reduce(out)
        return out

    return eval_fn


def pad_rows(b: int, mesh: Mesh) -> torch.Tensor:
    """The episode rows of a batch of b padded, by wrapping, to a multiple
    of the episode axis's extent: arange(target) % b (the rows
    wrap_pad_episodes takes)."""
    extent = mesh.shape[DATA_AXIS]
    return torch.arange(-(-b // extent) * extent) % b


def wrap_pad_episodes(xb, mesh: Mesh):
    """(batch padded to a multiple of the episode axis's extent by wrapping
    episodes, original size b): eval trims the duplicates with [:b]; in
    training they weigh once an epoch (JAX mesh.py:157-173)."""
    b = xb.shape[0]
    rows = pad_rows(b, mesh)
    if rows.shape[0] == b:
        return xb, b
    return xb[rows.numpy() if isinstance(xb, np.ndarray) else rows], b
