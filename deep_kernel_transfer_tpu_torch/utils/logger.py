"""Metrics logging: an append-only JSONL stream, and TensorBoard when
tensorboardX imports.

Port of deep_kernel_transfer_tpu/utils/logger.py (reference
methods/DKT.py:16-21, 52-56, 167-196): the same JSONL records, among them
the z_support histogram's summary `z_support/{mean,std,min,max}`.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._file = None
        self._tb = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log_scalars(self, step: int, **scalars) -> None:
        if self._file is None:
            return
        record = {"step": int(step), "time": time.time()}
        for name, value in scalars.items():
            record[name] = float(value)
            if self._tb is not None:
                self._tb.add_scalar(name, float(value), step)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_histogram(self, step: int, name: str, values) -> None:
        """The JSONL record keeps the histogram's summary statistics."""
        if self._file is None:
            return
        v = np.asarray(values).ravel()
        record = {"step": int(step), "time": time.time(),
                  f"{name}/mean": float(v.mean()), f"{name}/std": float(v.std()),
                  f"{name}/min": float(v.min()), f"{name}/max": float(v.max())}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._tb is not None:
            self._tb.add_histogram(name, v, step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
