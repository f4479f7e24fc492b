"""The feature cache of save_features: {all_feats, all_labels, count}.

Port of deep_kernel_transfer_tpu/data/feature_cache.py:1-68 (reference
save_features.py:20-41, data/feature_loader.py:24-44), the same layout, so
a cache written by either package is read by the other. It is written as
HDF5 when h5py can be imported, else as `<path>.npz`; both are read.
"""
from __future__ import annotations

import os
from collections import defaultdict

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError:
        return None
    return h5py


def cache_file(path: str) -> str | None:
    """The file that holds the cache named `path` (HDF5 at `path`, or
    `path`.npz), or None."""
    for p in (path, path + ".npz"):
        if os.path.isfile(p):
            return p
    return None


def save_features(out_path: str, feats: np.ndarray,
                  labels: np.ndarray) -> str:
    """Write {all_feats [N, ...], all_labels [N], count}; returns the file
    written."""
    h5py = _h5py()
    if h5py is None:
        np.savez(out_path + ".npz", all_feats=feats, all_labels=labels,
                 count=len(labels))
        return out_path + ".npz"
    with h5py.File(out_path, "w") as f:
        f.create_dataset("all_feats", data=feats)
        f.create_dataset("all_labels", data=labels)
        f.create_dataset("count", data=np.asarray(len(labels)))
    return out_path


def init_loader(path: str) -> dict[int, list[np.ndarray]]:
    """Read the cache into {class: [feat, ...]}, trimming a zero-padded
    tail by `count`."""
    h5py = _h5py()
    found = cache_file(path)
    if found is None:
        raise FileNotFoundError(f"{path} not found: run save_features first")
    if found.endswith(".npz"):
        with np.load(found) as z:
            feats, labels, count = (z["all_feats"], z["all_labels"],
                                    int(z["count"]))
    else:
        if h5py is None:
            raise RuntimeError(f"{found} is HDF5 and h5py is not installed")
        with h5py.File(found, "r") as f:
            feats = f["all_feats"][...]
            labels = f["all_labels"][...]
            count = int(np.asarray(f["count"]))
    cl_data: dict[int, list[np.ndarray]] = defaultdict(list)
    for feat, label in zip(feats[:count], labels[:count]):
        cl_data[int(label)].append(feat)
    return dict(cl_data)


def sample_feature_episode(cl_data: dict[int, list[np.ndarray]],
                           rng: np.random.RandomState, n_way: int,
                           n_support: int, n_query: int) -> np.ndarray:
    """[n_way, S+Q, ...] episode of cached features, with the JAX
    package's draws (reference test.py:39-50): n_way classes from a
    permutation of the sorted class ids, S+Q features a class without
    replacement (with replacement when a class is too small)."""
    classes = rng.permutation(sorted(cl_data.keys()))[:n_way]
    k = n_support + n_query
    z = []
    for cl in classes:
        feats = cl_data[int(cl)]
        idx = (rng.permutation(len(feats))[:k] if len(feats) >= k
               else rng.choice(len(feats), k, replace=True))
        z.append(np.stack([np.squeeze(feats[i]) for i in idx]))
    return np.stack(z).astype(np.float32)
