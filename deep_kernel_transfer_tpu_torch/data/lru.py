"""Byte-capped LRU cache for decoded images.

Copy of deep_kernel_transfer_tpu/data/lru.py: the episodic filelist
loader keeps its eval-transformed images here instead of re-decoding them
for every episode, as the reference's DataLoader workers do (reference
data/datamgr.py:82).
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class ByteCappedLRU:
    """path -> decoded ndarray, bounded by total byte size.

    * hits move the entry to the end (dict insertion order = recency);
    * misses evict least-recently-used entries until the new one fits;
    * entries larger than the whole cap are returned uncached (never
      flush the cache for an item that cannot fit);
    * cap <= 0 disables caching entirely.
    """

    def __init__(self, cap_bytes: int):
        self.cap = int(cap_bytes)
        self._data: dict[str, np.ndarray] = {}
        self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._data)

    def get_or_load(self, key: str,
                    load: Callable[[str], np.ndarray]) -> np.ndarray:
        if self.cap <= 0:
            return load(key)
        arr = self._data.get(key)
        if arr is None:
            arr = load(key)
            if arr.nbytes > self.cap:
                return arr
            while self._bytes + arr.nbytes > self.cap and self._data:
                old = self._data.pop(next(iter(self._data)))
                self._bytes -= old.nbytes
            self._data[key] = arr
            self._bytes += arr.nbytes
        else:  # refresh recency
            self._data.pop(key)
            self._data[key] = arr
        return arr
