"""Episodic data over JSON filelists, streamed from the host.

Port of deep_kernel_transfer_tpu/data/filelist.py:31-186 (reference
data/dataset.py + data/datamgr.py). The on-disk format is the reference's
base/val/novel.json:
  {"label_names": [...], "image_names": [...], "image_labels": [...]}

`EpisodicDataLoader` yields [B, n_way, S+Q, H, W, C] uint8 numpy batches
from a background thread. Its numpy RandomState draws are the JAX package's, in
the same order, so a seed gives the very same episodes in both packages.
`SimpleDataLoader` yields the baseline pretraining's flat (images,
labels) minibatches, with the JAX package's draws as well.
"""
from __future__ import annotations

import json
import queue
import threading
from typing import Iterator

import numpy as np

from .lru import ByteCappedLRU
from .transforms import TransformPipeline


class FileListMeta:
    def __init__(self, data_file: str):
        with open(data_file) as f:
            self.meta = json.load(f)
        self.image_names = self.meta["image_names"]
        self.image_labels = np.asarray(self.meta["image_labels"])

    def by_class(self) -> dict[int, list[str]]:
        sub: dict[int, list[str]] = {}
        for name, label in zip(self.image_names, self.image_labels):
            sub.setdefault(int(label), []).append(name)
        return sub


class SimpleDataLoader:
    """Shuffled flat (images [b, H, W, C] uint8, labels [b]) minibatches
    (reference SimpleDataset + SimpleDataManager, data/dataset.py:10-26,
    data/datamgr.py:54-66; JAX data/filelist.py:46-71): one permutation of
    the split per epoch from a numpy RandomState, and a last partial
    batch."""

    def __init__(self, data_file: str, image_size: int, batch_size: int,
                 aug: bool, seed: int = 0):
        self.meta = FileListMeta(data_file)
        self.batch_size = batch_size
        self.transform = TransformPipeline(image_size, aug, seed=seed)
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return -(-len(self.meta.image_names) // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = self.rng.permutation(len(self.meta.image_names))
        for i in range(len(self)):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            imgs = np.stack([self.transform.load(self.meta.image_names[j])
                             for j in idx])
            yield imgs, self.meta.image_labels[idx]


class EpisodicDataLoader:
    """Batched episodic sampler (reference SetDataset + EpisodicBatchSampler,
    data/dataset.py:29-87). Each episode: n_way classes without
    replacement, then S+Q images per class without replacement (with
    replacement only when a class is too small). Eval loaders (aug=False)
    keep the transformed images in a 1 GiB LRU."""

    def __init__(self, data_file: str, image_size: int, n_way: int,
                 n_support: int, n_query: int, n_episodes: int = 100,
                 episode_batch: int = 1, aug: bool = False, seed: int = 0):
        self.sub_meta = FileListMeta(data_file).by_class()
        self.classes = sorted(self.sub_meta.keys())
        self.n_way = n_way
        self.k = n_support + n_query
        self.n_episodes = n_episodes
        self.episode_batch = episode_batch
        self.transform = TransformPipeline(image_size, aug, seed=seed)
        self.rng = np.random.RandomState(seed)
        self._cache = ByteCappedLRU(0 if aug else 1 << 30)

    def __len__(self) -> int:
        """Number of yielded batches (episodes / batch, rounded up)."""
        return -(-self.n_episodes // self.episode_batch)

    def _load(self, path: str) -> np.ndarray:
        return self._cache.get_or_load(path, self.transform.load)

    def _one_episode(self) -> np.ndarray:
        way_ids = self.rng.permutation(len(self.classes))[: self.n_way]
        episode = []
        for w in way_ids:
            paths = self.sub_meta[self.classes[w]]
            replace = len(paths) < self.k
            img_ids = self.rng.choice(len(paths), self.k, replace=replace)
            episode.append(np.stack([self._load(paths[j]) for j in img_ids]))
        return np.stack(episode)  # [n_way, S+Q, H, W, C]

    def _batches(self) -> Iterator[np.ndarray]:
        remaining = self.n_episodes
        while remaining > 0:
            b = min(self.episode_batch, remaining)
            yield np.stack([self._one_episode() for _ in range(b)])
            remaining -= b

    def __iter__(self) -> Iterator[np.ndarray]:
        q: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._batches():
                    if not put_or_stop(batch):
                        return
                put_or_stop(done)
            except BaseException as e:  # a decode error ends the epoch loudly
                put_or_stop(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the loader is reused across epochs: wait for the producer, so
            # that it cannot race the next epoch's over the RNG and the LRU
            stop.set()
            t.join()
