"""A split staged once in device memory; episodes sampled on the device.

Port of deep_kernel_transfer_tpu/data/device_dataset.py:

  1. decode and eval-transform every image of a split once on the host,
     through the native decoder's thread pool where it builds, else PIL,
     in chunks of 1024 (or read the stage cache that an earlier run, of
     either package, left beside the filelist),
  2. hold the split as one [n_images, H, W, 3] uint8 tensor on the device,
     with a [n_class, width] slot table and the per-class counts,
  3. draw episodes with a `torch.Generator` on the device and gather them:
     an epoch or a 600-episode eval moves no pixels from the host.

Episode composition follows the reference's rules (data/dataset.py:29-87):
n_way distinct classes, S+Q images a class without replacement, with
replacement only when a class holds fewer than S+Q images. The draws come
from `torch.Generator`, not `jax.random`, so a seed gives other (equally
distributed) episodes than the JAX package's device path; the host loader
(data/filelist.py) gives the same ones.

`canvas=True` stages each whole image resized to a square int(1.15 *
image_size) canvas for the on-device augmentation (data/device_aug.py).

The training and eval loops here keep losses and accuracies on the device;
the caller reads them back at its print boundaries and at the end, since a
read-back in every step would make the host wait for the card each time.
"""
from __future__ import annotations

import copy
import hashlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..utils.profiling import annotate
from .filelist import FileListMeta
from .transforms import TransformPipeline, load_canvas_batch

STAGE_CHUNK = 1024  # images a decode call: bounds the native f32 buffer

# ------------------------------------------------------------- stage cache
# The decoded uint8 tensor of a split is kept on disk beside its filelist,
# keyed by the path list, each file's (mtime, size) and the staging
# geometry, so that a later run stages at disk speed. The file names and
# the key are the JAX package's (device_dataset.py:57-111): a split staged
# by either package is read by the other. Opt out: DKT_NO_STAGE_CACHE=1.


def _stage_cache_paths(data_file: str, image_size: int,
                       canvas: bool) -> tuple[str, str]:
    tag = f"{image_size}{'c' if canvas else ''}"
    base = f"{data_file}.stage{tag}"
    return base + ".npy", base + ".key"


def _stage_cache_key(paths: list[str], image_size: int, canvas: bool) -> str:
    h = hashlib.sha1()
    h.update(f"v1|{image_size}|{canvas}".encode())
    for p in paths:
        try:
            st = os.stat(p)
            h.update(f"{p}|{st.st_mtime_ns}|{st.st_size}".encode())
        except OSError:
            h.update(f"{p}|missing".encode())
    return h.hexdigest()


def _stage_cache_load(data_file: str, paths: list[str], image_size: int,
                      canvas: bool) -> tuple[Optional[np.ndarray], str]:
    """(the cached tensor or None, the key, for the store after a miss)."""
    if os.environ.get("DKT_NO_STAGE_CACHE"):
        return None, ""
    key = _stage_cache_key(paths, image_size, canvas)
    npy, keyf = _stage_cache_paths(data_file, image_size, canvas)
    try:
        with open(keyf) as f:
            if f.read().strip() != key:
                return None, key
        host = np.load(npy, mmap_mode="r")
    except (OSError, ValueError):
        return None, key
    if host.shape[0] != len(paths) or host.dtype != np.uint8:
        return None, key
    return host, key


def _stage_cache_store(data_file: str, key: str, image_size: int,
                       canvas: bool, host: np.ndarray) -> None:
    if os.environ.get("DKT_NO_STAGE_CACHE") or not key:
        return
    npy, keyf = _stage_cache_paths(data_file, image_size, canvas)
    try:
        tmp = npy + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:  # np.save(str) would append .npy
            np.save(f, host)
        os.replace(tmp, npy)
        with open(keyf, "w") as f:
            f.write(key)
    except OSError:
        pass  # a read-only filelist directory: the cache is best-effort


def _to_device(host: np.ndarray, device: torch.device,
               chunk: int = 4096) -> torch.Tensor:
    """The (possibly memory-mapped) host array on `device`, copied in
    chunks so the host never holds a second whole copy."""
    out = torch.empty(host.shape, dtype=torch.uint8, device=device)
    for i in range(0, host.shape[0], chunk):
        out[i:i + chunk].copy_(torch.from_numpy(np.array(host[i:i + chunk])))
    return out


class DeviceDataset:
    """One split resident in device memory, with its episode sampler."""

    def __init__(self, data_file: str, image_size: int, canvas: bool = False,
                 device=None, verbose: bool = False):
        self.device = resolve_device(device)
        sub = FileListMeta(data_file).by_class()
        classes = sorted(sub.keys())
        # each unique (path, label) once: a path listed under two classes
        # stages twice, as the streaming loader emits it under both
        paths: list[str] = []
        labels: list[int] = []
        path_id: dict[tuple[str, int], int] = {}
        for c in classes:
            for p in sub[c]:
                if (p, c) not in path_id:
                    path_id[(p, c)] = len(paths)
                    paths.append(p)
                    labels.append(c)

        t0 = time.perf_counter()
        host, cache_key = _stage_cache_load(data_file, paths, image_size,
                                            canvas)
        self.from_cache = host is not None
        self.decoder = "stage cache"  # or what decoded the split
        if host is None:
            size = int(image_size * 1.15) if canvas else image_size
            tp = TransformPipeline(image_size, aug=False)
            self.decoder = "native decoder" if tp.use_native else "PIL"
            host = np.empty((len(paths), size, size, 3), np.uint8)
            for i in range(0, len(paths), STAGE_CHUNK):
                chunk = paths[i:i + STAGE_CHUNK]
                host[i:i + STAGE_CHUNK] = (load_canvas_batch(chunk, size)
                                           if canvas else tp.load_batch(chunk))
            _stage_cache_store(data_file, cache_key, image_size, canvas, host)
        t1 = time.perf_counter()

        counts = np.array([len(sub[c]) for c in classes], np.int64)
        # slot j of class c is image j % count(c); only the first count(c)
        # slots are drawn (_sample_ids), the wrap keeps the table rectangular
        width = max(int(counts.max()), 128)
        table = np.empty((len(classes), width), np.int64)
        for ci, c in enumerate(classes):
            ids = np.array([path_id[(p, c)] for p in sub[c]], np.int64)
            table[ci] = np.tile(ids, -(-width // len(ids)))[:width]

        self.canvas = canvas
        self.mesh = None  # see shard
        self.image_labels = np.asarray(labels, np.int32)  # staged order
        self.images = _to_device(host, self.device)    # [n_img, H, W, 3] u8
        self.table = torch.from_numpy(table).to(self.device)
        self.counts = torch.from_numpy(counts).to(self.device)
        if verbose:
            # with the cache: t1 - t0 is its key (a stat of every file)
            # and the array's mapping; the read happens in the copy
            print(f"[device_data] staged {len(paths)} images "
                  f"({host.nbytes / 1e6:.1f} MB uint8) -> {self.device}: "
                  f"{self.decoder} {t1 - t0:.2f} s, read and copy "
                  f"{time.perf_counter() - t1:.2f} s", flush=True)

    @classmethod
    def from_arrays(cls, images: torch.Tensor, table: torch.Tensor,
                    counts: torch.Tensor,
                    canvas: bool = False) -> "DeviceDataset":
        """A split already on the device, with no files staged: images
        [n_img, H, W, 3] uint8, the slot table [n_class, width] (slot j of
        class c is image j % counts[c]) and the per-class counts, all on
        the images' device."""
        ds = cls.__new__(cls)
        ds.device = images.device
        ds.canvas, ds.mesh = canvas, None
        ds.images, ds.table, ds.counts = images, table, counts
        return ds

    def shard(self, mesh) -> "DeviceDataset":
        """A shallow copy for episode-parallel runs (JAX
        device_dataset.py:209-228): the split on this rank's device (each
        rank stages it on its own card), and episode batches cut to the
        rows of this rank's dp coordinate. Every rank draws the whole
        global batch's episodes and augmentation from the same generator
        and keeps its rows, so a seed gives the N-rank run the one-process
        run's episodes. A batch that does not divide over the dp extent is
        padded by wrapping
        (parallel.mesh.pad_rows): eval trims the duplicates. The receiver
        is left as it was."""
        new = copy.copy(self)
        new.device = mesh.device
        new.images = self.images.to(mesh.device)
        new.table = self.table.to(mesh.device)
        new.counts = self.counts.to(mesh.device)
        new.mesh = mesh
        return new

    def generator(self, seed: int) -> torch.Generator:
        """A generator on this split's device, seeded."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def sample_episode_ids(self, gen: torch.Generator, n_way: int, k: int,
                           batch: int) -> torch.Tensor:
        """[batch, n_way, k] image ids, by the reference's rules."""
        if k > self.table.shape[1]:
            raise ValueError(f"S+Q={k} exceeds the slot table's width "
                             f"{self.table.shape[1]}")
        return _sample_ids(self.table, self.counts, gen, n_way, k, batch)

    def sample_episodes(self, gen: torch.Generator, n_way: int,
                        n_support: int, n_query: int,
                        batch: int = 1) -> torch.Tensor:
        """[batch, n_way, S+Q, H, W, 3] uint8 on the device (this rank's
        rows of them when sharded)."""
        return _draw(self, gen, n_way, n_support, n_query, batch, None)

    def epoch(self, seed: int, n_way: int, n_support: int, n_query: int,
              n_episodes: int, episode_batch: int = 1,
              augment_to: Optional[int] = None) -> Iterator[torch.Tensor]:
        """EpisodicDataLoader-shaped iterator of device batches;
        `augment_to` runs the on-device augmentation (canvas staging
        only)."""
        _check_augment(self, augment_to)
        gen = self.generator(seed)
        remaining = n_episodes
        while remaining > 0:
            b = min(episode_batch, remaining)
            yield _draw(self, gen, n_way, n_support, n_query, b, augment_to)
            remaining -= b


def _check_augment(ds: DeviceDataset, augment_to: Optional[int]) -> None:
    if augment_to is not None and not ds.canvas:
        raise ValueError("augmentation needs canvas staging "
                         "(DeviceDataset(canvas=True))")
    if ds.canvas and augment_to is None:
        raise ValueError("canvas-staged images must be augmented down to the "
                         "model size")


def _draw(ds: DeviceDataset, gen, n_way, n_support, n_query, batch,
          augment_to):
    with annotate("draw"):
        k = n_support + n_query
        ids = ds.sample_episode_ids(gen, n_way, k, batch)
        rows = None
        if ds.mesh is not None:
            from ..parallel.mesh import pad_rows

            rows = pad_rows(batch, ds.mesh).to(ds.device)
            # the rows of this rank's dp coordinate: the tp ranks of one dp
            # group take the same episodes and augmentation
            local = rows.shape[0] // ds.mesh.dp
            rows = rows[ds.mesh.dp_rank * local:(ds.mesh.dp_rank + 1)
                        * local]
            ids = ids[rows]
        x = ds.images[ids]
        if augment_to is not None:
            from .device_aug import apply_augment, draw_augment

            with annotate("augment"):
                per = n_way * k  # images an episode
                draws = draw_augment(gen, batch * per, x.shape[-3],
                                     augment_to, ds.device)
                if rows is not None:
                    idx = (rows[:, None] * per + torch.arange(
                        per, device=ds.device)).reshape(-1)
                    draws = tuple(d[idx] for d in draws)
                x = apply_augment(x, draws, augment_to)
        return x


def make_fused_epoch(model, ds: DeviceDataset, n_way: int, n_support: int,
                     n_query: int, episode_batch: int,
                     augment_to: Optional[int] = None, step=None):
    """sample -> (augment) -> train_step as one device loop (JAX
    device_dataset.py:278-333, a lax.scan there).

    Returns chunk(gen, length, batch=episode_batch) -> (metrics, last):
    `length` training steps on episodes drawn from `gen`; `metrics` holds
    each of train_step's metrics stacked over the steps, still on the
    device; `last` is the last episode batch (for the telemetry). `step`
    maps an episode batch to its metrics in place of model.train_step
    (the episode-parallel step)."""
    _check_augment(ds, augment_to)
    step = step or model.train_step

    def chunk(gen: torch.Generator, length: int, batch: int = episode_batch):
        steps = []
        for _ in range(length):
            x = _draw(ds, gen, n_way, n_support, n_query, batch, augment_to)
            steps.append(step(x))
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}, x

    return chunk


def make_fused_eval(model, ds: DeviceDataset, n_way: int, n_support: int,
                    n_query: int, episode_batch: int, correct=None):
    """sample -> batch_correct as one device loop (JAX
    device_dataset.py:336-361). Returns eval_chunk(gen, length,
    batch=episode_batch) -> per-episode accuracy% [length, batch] on the
    device. `correct` maps an episode batch to its accuracies in place of
    model.batch_correct (the test-time heads, the episode-parallel eval,
    whose padded rows are trimmed here)."""
    correct = correct or model.batch_correct

    def eval_chunk(gen: torch.Generator, length: int,
                   batch: int = episode_batch) -> torch.Tensor:
        return torch.stack([
            correct(ds.sample_episodes(gen, n_way, n_support, n_query,
                                       batch))[:batch]
            for _ in range(length)])

    return eval_chunk


def fused_protocol_accs(eval_chunk, gen: torch.Generator, n_episodes: int,
                        episode_batch: int) -> torch.Tensor:
    """An n_episodes eval protocol through make_fused_eval's chunk: the
    full batches, then the remainder as one smaller batch. Per-episode
    accuracy% [n_episodes], on the device (JAX device_dataset.py:364-381)."""
    nb_full, rem = divmod(n_episodes, episode_batch)
    parts = []
    if nb_full:
        parts.append(eval_chunk(gen, nb_full).reshape(-1))
    if rem:
        parts.append(eval_chunk(gen, 1, rem).reshape(-1))
    return torch.cat(parts)


def _sample_ids(table: torch.Tensor, counts: torch.Tensor,
                gen: torch.Generator, n_way: int, k: int,
                batch: int) -> torch.Tensor:
    """Episode composition for a batch of episodes at once (JAX
    device_dataset.py:384-408): the ways are the first n_way of an argsort
    of uniforms over the classes; k images a way without replacement are
    the first k of an argsort of uniforms masked past the class's count;
    a class with fewer than k images takes floor(u * count) for each draw
    instead, exactly uniform with replacement."""
    n_class, width = table.shape
    dev = table.device
    ways = torch.argsort(torch.rand(batch, n_class, generator=gen,
                                    device=dev), dim=1)[:, :n_way]
    cnt = counts[ways]                                      # [B, n_way]
    u = torch.rand(batch, n_way, width, generator=gen, device=dev)
    real = torch.arange(width, device=dev) < cnt[..., None]
    picks_wo = torch.argsort(torch.where(real, u, torch.inf),
                             dim=-1)[..., :k]
    picks_w = torch.minimum(torch.floor(u[..., :k] * cnt[..., None]).long(),
                            cnt[..., None] - 1)
    picks = torch.where((cnt >= k)[..., None], picks_wo, picks_w)
    return table[ways[..., None], picks]


_CACHE: dict = {}


def cached_dataset(data_file: str, image_size: int, canvas: bool = False,
                   device=None, verbose: bool = False) -> DeviceDataset:
    """Stage each split once per process (train and val, --repeat runs)."""
    device = resolve_device(device)
    key = (os.path.abspath(data_file), os.path.getmtime(data_file),
           image_size, canvas, str(device))
    if key not in _CACHE:
        _CACHE[key] = DeviceDataset(data_file, image_size, canvas=canvas,
                                    device=device, verbose=verbose)
    return _CACHE[key]


def fits_budget(data_file: str, image_size: int, canvas: bool = False,
                budget_bytes: int = 4 << 30) -> bool:
    """Would the staged split fit in `budget_bytes`?"""
    size = int(image_size * 1.15) if canvas else image_size
    n = len(FileListMeta(data_file).image_names)
    return n * size * size * 3 <= budget_bytes
