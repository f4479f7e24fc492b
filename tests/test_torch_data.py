"""The port's data path (deep_kernel_transfer_tpu_torch/data) against the
JAX package's: the eval and canvas pixels of the host transforms, the
episodes of EpisodicDataLoader for a seed, the stage cache read across
the two packages, the device sampler's composition rules and the staging
budget. Both packages take their PIL path: their native decoders are
switched off for the test (`native.available -> False` in each;
tests/test_torch_native.py holds the two native decoders together).
Pixels and episodes must be identical.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from deep_kernel_transfer_tpu import native as jnative
from deep_kernel_transfer_tpu_torch import native as tnative
from deep_kernel_transfer_tpu.data import device_dataset as jdd
from deep_kernel_transfer_tpu.data import filelist as jfl
from deep_kernel_transfer_tpu.data import transforms as jtr
from deep_kernel_transfer_tpu_torch.data import device_dataset as tdd
from deep_kernel_transfer_tpu_torch.data import filelist as tfl
from deep_kernel_transfer_tpu_torch.data import transforms as ttr
from torch_test_threads import one_thread  # noqa: F401

SIZES = [8, 8, 8, 3, 8]  # class 3 is smaller than S+Q = 5


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.fixture(scope="module")
def filelist(tmp_path_factory):
    """5 classes, JPEG and PNG files of several sizes and aspects."""
    root = tmp_path_factory.mktemp("port_data")
    rng = np.random.RandomState(7)
    names, labels = [], []
    shapes = [(24, 24), (30, 20), (17, 40)]
    for cl, n in enumerate(SIZES):
        for i in range(n):
            h, w = shapes[(cl + i) % 3]
            arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            p = str(root / f"c{cl}_{i}.{'png' if i % 2 else 'jpg'}")
            Image.fromarray(arr).save(p)
            names.append(p)
            labels.append(cl)
    jf = str(root / "novel.json")
    with open(jf, "w") as f:
        json.dump({"label_names": [f"c{i}" for i in range(5)],
                   "image_names": names, "image_labels": labels}, f)
    return jf, names


def test_eval_pixels_match_jax(filelist):
    _, names = filelist
    t = ttr.TransformPipeline(16, aug=False)
    j = jtr.TransformPipeline(16, aug=False, output_uint8=True,
                              use_native=False)
    got, want = t.load_batch(names), j.load_batch(names)
    assert got.shape == (len(names), 16, 16, 3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_aug_pixels_match_jax(filelist):
    """The host aug pipeline draws in the JAX package's order."""
    _, names = filelist
    t = ttr.TransformPipeline(16, aug=True, seed=3)
    j = jtr.TransformPipeline(16, aug=True, seed=3, output_uint8=True,
                              use_native=False)
    for p in names[:12]:
        assert np.array_equal(t.load(p), j.load(p))


def test_canvas_pixels_match_jax(filelist):
    _, names = filelist
    for p in names[:10]:
        got = ttr.load_canvas(p, 18)
        assert got.shape == (18, 18, 3)
        assert np.array_equal(got, jdd._load_canvas(p, 18))


@pytest.mark.parametrize("aug", [False, True])
def test_episodic_loader_matches_jax(filelist, aug):
    jf, _ = filelist
    kw = dict(n_episodes=5, episode_batch=2, aug=aug, seed=11)
    got = list(tfl.EpisodicDataLoader(jf, 16, 4, 2, 3, **kw))
    want = list(jfl.EpisodicDataLoader(jf, 16, 4, 2, 3, output_uint8=True,
                                       **kw))
    assert [g.shape for g in got] == [(2, 4, 5, 16, 16, 3)] * 2 + [
        (1, 4, 5, 16, 16, 3)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_filelist_meta_matches_jax(filelist):
    jf, _ = filelist
    assert tfl.FileListMeta(jf).by_class() == jfl.FileListMeta(jf).by_class()


@pytest.mark.parametrize("canvas", [False, True])
def test_stage_cache_read_across_packages(filelist, canvas, monkeypatch):
    """A split staged by the JAX DeviceDataset is read from its cache by
    the port's, and the reverse; neither decodes."""
    jf, names = filelist
    monkeypatch.delenv("DKT_NO_STAGE_CACHE", raising=False)
    assert (tdd._stage_cache_key(names, 16, canvas)
            == jdd._stage_cache_key(names, 16, canvas))
    for path in tdd._stage_cache_paths(jf, 16, canvas):
        assert path in jdd._stage_cache_paths(jf, 16, canvas)
    jds = jdd.DeviceDataset(jf, 16, canvas=canvas)
    want = np.asarray(jds.images)

    def no_decode(*args, **kwargs):
        raise AssertionError("decoded instead of reading the stage cache")

    with monkeypatch.context() as mp:
        mp.setattr(tdd, "load_canvas_batch", no_decode)
        mp.setattr(tdd.TransformPipeline, "load_batch", no_decode)
        tds = tdd.DeviceDataset(jf, 16, canvas=canvas, device="cpu")
    assert tds.from_cache and np.array_equal(tds.images.numpy(), want)

    for path in tdd._stage_cache_paths(jf, 16, canvas):
        os.remove(path)
    fresh = tdd.DeviceDataset(jf, 16, canvas=canvas, device="cpu")
    assert not fresh.from_cache
    assert np.array_equal(fresh.images.numpy(), want)
    with monkeypatch.context() as mp:
        mp.setattr(jdd, "_load_canvas_batch", no_decode)
        mp.setattr(jdd.TransformPipeline, "load_batch", no_decode)
        again = jdd.DeviceDataset(jf, 16, canvas=canvas)
    assert np.array_equal(np.asarray(again.images), want)


def _composition(ds, gen, n_way, k, batch):
    ids = ds.sample_episode_ids(gen, n_way, k, batch).numpy()
    labels = np.repeat(np.arange(len(SIZES)), SIZES)  # staged class-major
    return ids, labels[ids]


def test_sample_ids_rules(filelist):
    """n_way distinct ways; every id in its way's class; no repeat within a
    way when count >= S+Q; a too-small class draws from its own images."""
    jf, _ = filelist
    ds = tdd.DeviceDataset(jf, 16, device="cpu")
    assert ds.images.shape == (35, 16, 16, 3) and ds.images.dtype == torch.uint8
    gen = ds.generator(0)
    ids, labels = _composition(ds, gen, 4, 5, 200)
    assert ids.shape == (200, 4, 5)
    ways = labels[..., 0]
    assert (labels == ways[..., None]).all()
    for b in range(200):
        assert len(set(ways[b])) == 4
        for w in range(4):
            if SIZES[ways[b, w]] >= 5:
                assert len(set(ids[b, w])) == 5
            else:
                assert set(ids[b, w]) <= {24, 25, 26}
    small = ids[ways == 3]
    assert len(small) > 50
    counts = np.bincount(small.ravel() - 24, minlength=3)
    assert counts.min() > 0.2 * counts.sum()  # uniform over the 3 images


def test_sample_episodes_and_epoch(filelist):
    jf, _ = filelist
    ds = tdd.DeviceDataset(jf, 16, device="cpu")
    x = ds.sample_episodes(ds.generator(1), 4, 2, 3, batch=3)
    assert x.shape == (3, 4, 5, 16, 16, 3) and x.dtype == torch.uint8
    batches = list(ds.epoch(5, 3, 2, 2, n_episodes=5, episode_batch=2))
    assert [b.shape[0] for b in batches] == [2, 2, 1]
    again = list(ds.epoch(5, 3, 2, 2, n_episodes=5, episode_batch=2))
    assert all(torch.equal(a, b) for a, b in zip(batches, again))
    with pytest.raises(ValueError, match="canvas"):
        next(ds.epoch(0, 3, 2, 2, n_episodes=1, augment_to=16))


def test_fits_budget(filelist):
    jf, _ = filelist
    n = sum(SIZES)
    for canvas in (False, True):
        size = 18 if canvas else 16
        for budget in (n * size * size * 3, n * size * size * 3 - 1):
            got = tdd.fits_budget(jf, 16, canvas, budget_bytes=budget)
            assert got == jdd.fits_budget(jf, 16, canvas, budget_bytes=budget)
            assert got == (budget >= n * size * size * 3)
