"""The port's digits data and filelist builders
(deep_kernel_transfer_tpu_torch/benchmarks/digits_real.py) against
scikit-learn's load_digits and the JAX package's benchmarks/digits_real.py:
the committed array equals load_digits; the filelists and JPEG bytes equal
the JAX script's; the glyph base is pixel-equal; the cross layout's splits
are equal.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from deep_kernel_transfer_tpu_torch.benchmarks import digits_real as tdr
from torch_test_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jdr():
    """The JAX package's benchmarks/digits_real.py, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_digits_real", os.path.join(REPO, "benchmarks", "digits_real.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_digits_npz_equals_load_digits():
    datasets = pytest.importorskip("sklearn.datasets")
    x, y = datasets.load_digits(return_X_y=True)
    gx, gy = tdr.load_digits_array()
    assert gx.shape == (1797, 64) and gy.shape == (1797,)
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_array_equal(gy, y)
    with np.load(tdr.DIGITS) as f:
        assert f["images"].dtype == f["labels"].dtype == np.uint8


def _tree(root):
    """{relative path: bytes} of every file under root/filelists, with the
    root's path taken out of the JSONs."""
    out = {}
    base = os.path.join(root, "filelists")
    for d, _, files in os.walk(base):
        for name in files:
            p = os.path.join(d, name)
            data = open(p, "rb").read()
            if name.endswith(".json"):
                data = data.replace(str(root).encode(), b"<root>")
            out[os.path.relpath(p, base)] = data
    return out


def test_digits_filelists_byte_equal_to_jax(jdr, tmp_path):
    pytest.importorskip("sklearn.datasets")
    jdr.make_digits_filelists(str(tmp_path / "jax"))
    tdr.make_digits_filelists(str(tmp_path / "port"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sum(k.endswith(".jpg") for k in got) == 1797
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want)
    novel = json.loads(got[os.path.join("omniglot", "novel.json")])
    assert sorted(set(novel["image_labels"])) == [5, 6, 7, 8, 9]


def test_first_glyph_class_pixel_equal_to_jax(jdr):
    want = jdr._render_glyph_class(np.random.RandomState(11), 20)
    got = tdr._render_glyph_class(np.random.RandomState(11), 20)
    assert len(got) == 20 and got[0].shape == (28, 28)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cross_filelists_byte_equal_to_jax(jdr, tmp_path):
    """A small glyph base (3 classes of 4) and the parity split."""
    pytest.importorskip("sklearn.datasets")
    jdr.make_cross_filelists(str(tmp_path / "jax"), n_classes=3, n_img=4)
    tdr.make_cross_filelists(str(tmp_path / "port"), n_classes=3, n_img=4)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want)
    val = json.loads(got[os.path.join("omniglot", "val.json")])
    assert sorted(set(val["image_labels"])) == [0, 2, 4, 6, 8]
