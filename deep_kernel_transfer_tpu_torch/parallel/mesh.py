"""Episode-parallel and tensor-parallel training and eval over
torch.distributed.

Port of deep_kernel_transfer_tpu/parallel/mesh.py. The JAX package shards
the episode axis of a batch over the "dp" axis of a device mesh and, on a
2-D dp x tp mesh, may shard large parameters over "tp"; XLA inserts the
collectives. Here one process drives one device (rank r on cuda:r; on the
CPU, processes over gloo) and the collectives are written out:

  * `make_mesh` joins the process group (started by `spawn_ranks` or by
    torchrun) or, for one rank, starts it: a 1-D mesh, dp = the world;
    `make_mesh_2d(dp, tp)` lays the ranks out as the JAX reshape(dp, tp)
    does, rank r at dp coordinate r // tp and tp coordinate r % tp, and
    builds the dp groups (the ranks of one tp coordinate) and the tp
    groups (the ranks of one dp coordinate);
  * `replicate_tree` broadcasts parameters, buffers and optimizer state
    from rank 0, so every rank starts from rank 0's draws;
  * `make_sharded_train_step` runs methods/base.py::train_step_body with
    the gradients, the BatchNorm statistics and the loss averaged over the
    dp group before the update (the local batches are of equal size, so
    the mean of the ranks' means is the global mean: the JAX psum). With
    `param_shardings` (from `tensor_sharding_rules`) each rank stores only
    its tp chunk of the large weights between steps, and Adam's moments
    of them are chunk-sized too; a step all-gathers the chunks over the tp
    group into whole weights, outside autograd, and runs on those. The tp
    ranks of one dp group take the same episodes and compute the same
    full gradient, so a chunk's gradient is its slice of it;
  * `make_sharded_eval` gathers the dp groups' per-episode accuracies.

The backend is NCCL on the card and gloo on the CPU. Only broadcast,
all_gather and all_reduce are used, which gloo also runs on CUDA tensors
(several ranks on one card, where NCCL refuses). Importing this module
starts no process group.
"""
from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import socket
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
TIMEOUT = datetime.timedelta(seconds=300)  # a collective waiting longer fails


@dataclass(frozen=True)
class Mesh:
    """This process's place on the mesh: its rank, the number of ranks and
    its device. A 1-D mesh (make_mesh) is all dp: tp = 1, no tp group,
    and its dp group is the default group. A 2-D mesh (make_mesh_2d) also
    holds the tp extent and this rank's two sub-groups."""
    rank: int
    size: int
    device: torch.device
    tp: int = 1
    dp_group: Any = None  # the ranks of this tp coordinate; None: all
    tp_group: Any = None  # the ranks of this dp coordinate

    @property
    def dp(self) -> int:
        return self.size // self.tp

    @property
    def dp_rank(self) -> int:
        """This rank's coordinate on the dp axis: the episode shard it
        takes."""
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate on the tp axis: the chunk of each sharded
        parameter it stores."""
        return self.rank % self.tp

    @property
    def shape(self) -> dict[str, int]:
        """The extent of each mesh axis, as a JAX mesh's `shape`: dp, and
        tp on a 2-D mesh."""
        if self.tp_group is None:
            return {DATA_AXIS: self.dp}
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


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


def _check_devices(local: int, device: torch.device, caller: str) -> None:
    """Raise when this host would run more ranks than it has devices."""
    available = local_device_count(device)
    if local > available:
        raise ValueError(
            f"{caller}: only {available} devices available (silently "
            f"truncating would run with less parallelism than the "
            f"per-device batch math assumes)")


def _join_group(n: Optional[int], device: torch.device, caller: str) -> None:
    """Join the process group that `spawn_ranks` or torchrun started
    (env://), or start a group of one rank when n is None or 1."""
    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:
        dist.init_process_group(_backend(device), init_method="env://",
                                timeout=TIMEOUT)
    elif n in (None, 1):
        dist.init_process_group(
            _backend(device), init_method=f"tcp://localhost:{free_port()}",
            world_size=1, rank=0, timeout=TIMEOUT)
    else:
        raise RuntimeError(f"{caller}: no process group; start the ranks "
                           f"with spawn_ranks or torchrun")


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The episode-parallel mesh of this process: joins the process group
    that `spawn_ranks` or torchrun started (env://), or starts a group of
    one rank. `n_devices` None takes the group's size. Raises when the
    host has fewer devices than ranks, or the group another size."""
    device = resolve_device(device)
    caller = f"make_mesh(n_devices={n_devices})"
    _check_devices(int(os.environ.get("LOCAL_WORLD_SIZE", n_devices or 1)),
                   device, caller)
    _join_group(n_devices, device, caller)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and size != n_devices:
        raise ValueError(f"{caller}: the process group has {size} ranks")
    return Mesh(rank, size, rank_device(device))


def make_mesh_2d(dp: int, tp: int, device=None) -> Mesh:
    """The (dp, tp) mesh of this process (JAX mesh.py:40-49): episodes
    sharded over dp, large parameters optionally over tp
    (tensor_sharding_rules). Joins the process group as make_mesh does;
    raises when the host lacks the devices or the group is not dp * tp
    ranks."""
    device = resolve_device(device)
    caller = f"make_mesh_2d(dp={dp}, tp={tp})"
    _check_devices(int(os.environ.get("LOCAL_WORLD_SIZE", dp * tp)),
                   device, caller)
    _join_group(dp * tp, device, caller)
    return grid_mesh(dp, tp, rank_device(device))


def grid_mesh(dp: int, tp: int, device: torch.device) -> Mesh:
    """The dp x tp mesh over the process group that is up, on `device` as
    given: no device check, so several ranks may share one card over gloo.
    Every rank creates every sub-group, in the same order."""
    size = dist.get_world_size()
    if size != dp * tp:
        raise ValueError(f"make_mesh_2d(dp={dp}, tp={tp}) needs {dp * tp} "
                         f"ranks, the process group has {size}")
    rank = dist.get_rank()
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)])
                 for t in range(tp)]
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)])
                 for d in range(dp)]
    return Mesh(rank, size, device, tp, dp_groups[rank % tp],
                tp_groups[rank // tp])


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
    _check_devices(n, device, f"make_mesh(n_devices={n})")
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
    a numpy array), on its device: the rows of its dp coordinate, which
    the tp ranks of one dp group share. B must divide by the dp extent."""
    b, extent = xb.shape[0], mesh.shape[DATA_AXIS]
    if b % extent:
        raise ValueError(f"episode batch {b} does not divide over {extent} "
                         f"ranks (wrap_pad_episodes first)")
    k = b // extent
    part = xb[mesh.dp_rank * k:(mesh.dp_rank + 1) * k]
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
    place by rank 0's. Returns tree. Call it before the parameters are
    sharded over tp: it would give every rank rank 0's chunks."""
    for t in _tensors(tree):
        buf = t if t.device == mesh.device else t.to(mesh.device)
        dist.broadcast(buf, 0)
        if buf is not t:
            t.copy_(buf)
    return tree


@torch.no_grad()
def _reduce_over_dp(tensors: list, mesh: Mesh, mean: bool) -> None:
    """Each floating tensor replaced in place by its sum (or mean) over
    the dp group: one all_reduce a dtype, the tensors laid end to end."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(mesh.device) for t in ts])
        dist.all_reduce(flat, group=mesh.dp_group)
        if mean:
            flat /= mesh.shape[DATA_AXIS]
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


def average(tensors: list, mesh: Mesh) -> None:
    """Each floating tensor replaced in place by its mean over the dp
    extent (the dp group's ranks): one all_reduce a dtype, over the
    tensors laid end to end."""
    _reduce_over_dp(tensors, mesh, mean=True)


class _DpSum(torch.autograd.Function):
    """t summed over the dp group; the backward sums the gradient over it
    too, which is the derivative of the ranks' summed losses."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = t.clone()
        dist.all_reduce(out, group=mesh.dp_group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.mesh.dp_group)
        return out, None


def dp_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """t summed over the dp group, with gradients: the BatchNorm
    statistics of a minibatch split over the ranks (BaselineTrain)."""
    return _DpSum.apply(t, mesh)


def loss_reduction(method) -> str:
    """"mean" or "sum": how the method's loss reduces its episodes (MAML
    sums them, reference maml.py:89-92), so how the ranks' losses and
    gradients combine."""
    return getattr(method, "loss_reduction", "mean")


def make_sharded_train_step(method, mesh: Mesh, param_shardings=None):
    """step(xb_local) -> metrics: the method's train_step on this rank's
    episodes, the same train_step_body as one process runs, with the
    gradients, BatchNorm statistics and loss averaged over the dp group
    before the update (JAX mesh.py:83-115); a method whose loss sums its
    episodes (MAML) sums them. Every rank must hold the same parameters
    first (replicate_tree). For BaselineTrain, step(x_local, y_local):
    the supervised minibatch split over the dp group, its BatchNorm
    statistics those of the whole minibatch (the JAX dry run's
    batch-sharded pretrain step).

    `param_shardings` (tensor_sharding_rules on a 2-D mesh) shards the
    method's parameters over tp in place, once, here (shard_parameters).
    Each step then all-gathers them whole, outside autograd, and runs the
    body on the whole tensors, so every method's gradients are the 1-D
    step's, second-order MAML's included; the hook cuts the reduced
    gradients and the weights back to this rank's chunks before the
    update, so Adam's moments stay chunk-sized. The tp ranks of a dp
    group take the same episodes and compute the same full gradient.
    Without it the method stays replicated."""
    from ..methods.baseline import BaselineTrain

    if param_shardings is not None:
        shard_parameters(method, mesh, param_shardings)
    mean = loss_reduction(method) == "mean"

    def reduce(ts):
        _reduce_over_dp(ts, mesh, mean)
        _cut(method)

    if isinstance(method, BaselineTrain):
        def batch_step(x_local: torch.Tensor, y_local: torch.Tensor) -> dict:
            with _whole_parameters(method):
                return method.train_step(
                    x_local, y_local, average=reduce,
                    batch_sum=lambda t: dp_sum(t, mesh))

        return batch_step

    def step(xb_local: torch.Tensor) -> dict:
        with _whole_parameters(method):
            return method.train_step(xb_local, average=reduce)

    return step


def tensor_sharding_rules(module: torch.nn.Module, mesh: Mesh,
                          axis: str = MODEL_AXIS,
                          min_size: int = 1 << 16) -> dict:
    """The JAX rule (mesh.py:121-140) in the port's layouts: parameter name
    -> (axis, dim) for a parameter stored in chunks over `axis` along
    `dim`, or None for a replicated one. A parameter is sharded when its
    JAX leaf has ndim >= 2 and size >= min_size and its trailing axis (the
    output channel of an HWIO conv or an [in, out] dense kernel) divides
    by the axis's extent. That axis is dim 0 of the port's OIHW convs and
    [out, in] Linear weights; utils/convert.py::flax_leaf_layout maps every
    other parameter (an LSTM's stacked gates are four JAX leaves). TP is
    not needed at these sizes (<= 44 M parameters); the rule is exposed
    anyway, as in the JAX package."""
    from ..utils.convert import flax_leaf_layout

    if axis not in mesh.shape:
        raise ValueError(f"sharding over {axis!r} needs a 2-D mesh "
                         f"(make_mesh_2d)")
    n = mesh.shape[axis]
    rules: dict = {}
    for name, p in module.named_parameters():
        layout = flax_leaf_layout(module, name)
        rules[name] = None
        if layout is not None:
            dim, stack = layout
            if (p.numel() // stack >= min_size
                    and (p.shape[dim] // stack) % n == 0):
                rules[name] = (axis, dim)
    return rules


class TensorParallelChunk:
    """How one tp-sharded parameter is stored: between steps the Parameter
    holds this rank's chunk along `dim` of its full shape; `gather`
    all-gathers the tp group's chunks into the full tensor, `cut` takes
    this rank's chunk of a full one. Neither is recorded by autograd: the
    step runs on the full tensor as a leaf, as one process does."""

    def __init__(self, dim: int, mesh: Mesh, full_shape: torch.Size):
        if mesh.tp_group is None:
            raise ValueError("tensor-parallel sharding needs a 2-D mesh "
                             "(make_mesh_2d)")
        if full_shape[dim] % mesh.tp:
            raise ValueError(f"dim {dim} of a {tuple(full_shape)} parameter "
                             f"does not divide over tp={mesh.tp}")
        self.dim, self.mesh = dim, mesh
        self.full_shape = tuple(full_shape)
        shape = list(full_shape)
        shape[dim] //= mesh.tp
        self.chunk_shape = tuple(shape)

    @torch.no_grad()
    def gather(self, chunk: torch.Tensor) -> torch.Tensor:
        if tuple(chunk.shape) != self.chunk_shape:
            raise ValueError(f"a tp chunk of shape {tuple(chunk.shape)}, "
                             f"want {self.chunk_shape}")
        parts = [torch.empty_like(chunk) for _ in range(self.mesh.tp)]
        dist.all_gather(parts, chunk.contiguous(), group=self.mesh.tp_group)
        return torch.cat(parts, self.dim)

    @torch.no_grad()
    def cut(self, full: torch.Tensor) -> torch.Tensor:
        if tuple(full.shape) != self.full_shape:
            raise ValueError(f"a parameter of shape {tuple(full.shape)}, "
                             f"want {self.full_shape}")
        part = full.chunk(self.mesh.tp, self.dim)[self.mesh.tp_rank]
        return part.clone(memory_format=torch.contiguous_format)


def tp_chunks(method) -> dict:
    """name -> TensorParallelChunk of each parameter of `method` that
    shard_parameters stores as a tp chunk; empty for a replicated one."""
    return getattr(method, "_tp_chunks", {})


def _whole(method) -> None:
    """Each tp-sharded parameter's .data made the full tensor, one
    all_gather a parameter over the tp group. An LSTM holding one is
    repacked for cuDNN (a no-op on the CPU)."""
    params = dict(method.named_parameters())
    for name, chunk in tp_chunks(method).items():
        params[name].data = chunk.gather(params[name].data)
    for name in {n.rpartition(".")[0] for n in tp_chunks(method)}:
        module = method.get_submodule(name)
        if isinstance(module, torch.nn.RNNBase):
            module.flatten_parameters()


def _cut(method) -> None:
    """Each tp-sharded parameter that is whole, and its gradient, cut back
    to this rank's chunk."""
    params = dict(method.named_parameters())
    for name, chunk in tp_chunks(method).items():
        p = params[name]
        if tuple(p.shape) == chunk.full_shape:
            p.data = chunk.cut(p.data)
        if p.grad is not None and tuple(p.grad.shape) == chunk.full_shape:
            p.grad = chunk.cut(p.grad)


@contextlib.contextmanager
def _whole_parameters(method):
    """The tp-sharded parameters of `method` whole inside the block and
    this rank's chunks after it (a collective: every rank of the tp group
    enters). Nothing to do for a replicated method."""
    if not tp_chunks(method):
        yield
        return
    _whole(method)
    try:
        yield
    finally:
        _cut(method)


@torch.no_grad()
def shard_parameters(method, mesh: Mesh, param_shardings: dict) -> None:
    """Store each parameter that `param_shardings` shards as this rank's
    tp chunk along its dim (a TensorParallelChunk in tp_chunks(method)),
    in place: the same Parameter object, so the optimizer's groups and
    learning rates stay; Adam moments it already holds are cut to the
    chunk too. The sharded step makes the parameters whole while it runs
    (_whole_parameters). The JAX step's with_sharding_constraint on the
    params (mesh.py:102-104)."""
    params = dict(method.named_parameters())
    unknown = set(param_shardings) - set(params)
    if unknown:
        raise ValueError(f"param_shardings names no parameter of the "
                         f"method: {sorted(unknown)}")
    state = method.optimizer.state if method.optimizer is not None else {}
    chunks = dict(tp_chunks(method))
    for name, rule in param_shardings.items():
        if rule is None:
            continue
        axis, dim = rule
        if axis != MODEL_AXIS:
            raise ValueError(f"{name}: parameters shard over "
                             f"{MODEL_AXIS!r}, not {axis!r}")
        p = params[name]
        chunk = TensorParallelChunk(dim, mesh, p.shape)
        for key, v in state.get(p, {}).items():
            if torch.is_tensor(v) and tuple(v.shape) == chunk.full_shape:
                state[p][key] = chunk.cut(v)
        p.data = chunk.cut(p.data)
        chunks[name] = chunk
    method._tp_chunks = chunks


@torch.no_grad()
def gather_state(method) -> dict:
    """The method's state_dict as a replicated run holds it: each
    tp-sharded parameter all-gathered. A collective: every rank calls it
    (rank 0 then saves, say with
    utils/checkpoint.py::save_checkpoint(..., state=...))."""
    with _whole_parameters(method):
        return dict(method.state_dict())


def make_sharded_eval(method, mesh: Mesh):
    """eval(xb_local) -> per-episode accuracy% [dp * B_local] of the
    global batch, on every rank: method.batch_correct on this rank's
    episodes, gathered in dp order (JAX mesh.py:143-154). The gather is
    an all_reduce over the dp group of the rank's block into zeros, which
    is exact."""
    def eval_fn(xb_local: torch.Tensor) -> torch.Tensor:
        with _whole_parameters(method):
            acc = method.batch_correct(xb_local).to(mesh.device)
        b = acc.shape[0]
        out = torch.zeros(mesh.shape[DATA_AXIS] * b, dtype=acc.dtype,
                          device=mesh.device)
        out[mesh.dp_rank * b:(mesh.dp_rank + 1) * b] = acc
        dist.all_reduce(out, group=mesh.dp_group)
        return out

    return eval_fn


def pad_rows(b: int, mesh: Mesh) -> torch.Tensor:
    """The episode rows of a batch of b padded, by wrapping, to a multiple
    of the dp extent: arange(target) % b (the rows wrap_pad_episodes
    takes)."""
    extent = mesh.shape[DATA_AXIS]
    return torch.arange(-(-b // extent) * extent) % b


def wrap_pad_episodes(xb, mesh: Mesh):
    """(batch padded to a multiple of the dp extent by wrapping episodes,
    original size b): eval trims the duplicates with [:b]; in training
    they weigh once an epoch. On a 2-D mesh only dp shards the batch, so
    the padding is to the dp extent, not to the number of ranks (JAX
    mesh.py:157-173)."""
    b = xb.shape[0]
    rows = pad_rows(b, mesh)
    if rows.shape[0] == b:
        return xb, b
    return xb[rows.numpy() if isinstance(xb, np.ndarray) else rows], b
