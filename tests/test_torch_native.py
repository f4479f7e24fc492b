"""The port's native image decoder (deep_kernel_transfer_tpu_torch/native,
built from csrc/image_pipeline.cc) against the JAX package's native
decoder and against PIL.

Both libraries compile the same source with the same command line, so
every output must be bit-equal to the JAX decoder's on the same JPEG, PNG
and grey files, and a split staged by the port must equal the JAX
package's byte for byte with both decoders on. Against PIL the JAX
package's tolerances hold (tests/test_native_pipeline.py:35-135): eval at
most 0.02 in normalised units (one u8 level is 0.0175 there), jitter a
mean of 0.03, canvases at most 6 u8 levels with a mean below 1.0. The
tests skip where the port's decoder does not build (no g++, libjpeg or
libpng); the skip is decided in a fixture.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from deep_kernel_transfer_tpu import native as jnative
from deep_kernel_transfer_tpu.data import device_dataset as jdd
from deep_kernel_transfer_tpu.data import transforms as jtr
from deep_kernel_transfer_tpu_torch import native as tnative
from deep_kernel_transfer_tpu_torch.data import device_dataset as tdd
from deep_kernel_transfer_tpu_torch.data import transforms as ttr
from torch_test_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    if not (tnative.available() and jnative.available()):
        pytest.skip("a native decoder did not build (g++, libjpeg, libpng)")
    d = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.RandomState(0)
    arr = (rng.rand(100, 120, 3) * 255).astype(np.uint8)
    jpg, png, gray = str(d / "t.jpg"), str(d / "t.png"), str(d / "g.png")
    Image.fromarray(arr).save(jpg, quality=95)
    Image.fromarray(arr).save(png)
    Image.fromarray((rng.rand(50, 60) * 255).astype(np.uint8), "L").save(gray)
    return jpg, png, gray


def test_source_is_the_jax_source():
    with open(os.path.join(REPO, "deep_kernel_transfer_tpu_torch", "csrc",
                           "image_pipeline.cc"), "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "deep_kernel_transfer_tpu", "native", "src",
                           "image_pipeline.cc"), "rb") as f:
        assert port == f.read()


def test_outputs_bit_equal_to_jax(images):
    jpg, png, gray = images
    for path in images:
        assert tnative.image_size(path) == jnative.image_size(path)
        for normalize in (True, False):
            np.testing.assert_array_equal(
                tnative.load_eval(path, 84, normalize),
                jnative.load_eval(path, 84, normalize))
        for box, factors, flip in (((5, 5, 40, 45), (1.2, 0.8, 1.1), True),
                                   (None, (0.7, 1.3, 0.9), False)):
            np.testing.assert_array_equal(
                tnative.load_aug(path, 64, box, factors, flip),
                jnative.load_aug(path, 64, box, factors, flip))
    paths = [jpg, png, gray, jpg]
    np.testing.assert_array_equal(tnative.load_eval_batch(paths, 84),
                                  jnative.load_eval_batch(paths, 84))
    np.testing.assert_array_equal(tnative.load_canvas_batch(paths, 96),
                                  jnative.load_canvas_batch(paths, 96))
    assert tnative.image_size(jpg) == (120, 100)


def test_eval_and_jitter_match_pil_within_jax_tolerances(images):
    for path in images:
        pil = jtr.TransformPipeline(84, aug=False, use_native=False)(
            jtr.load_image(path))
        assert np.abs(pil - tnative.load_eval(path, 84)).max() < 0.02, path
    jpg = images[0]
    img = jtr.load_image(jpg)
    w, h = img.size
    factors = (1.2, 0.7, 1.3)

    class FixedRng:  # image_jitter draws alpha * (2u - 1) + 1, alpha 0.4
        def rand(self, n=None):
            return np.array([(f - 1) / 0.4 / 2 + 0.5 for f in factors])

    pil = jtr.to_array(jtr.image_jitter(img.resize((64, 64), Image.BILINEAR),
                                        FixedRng()))
    nat = tnative.load_aug(jpg, 64, (0, 0, w, h), factors, False)
    assert np.abs(pil - nat).mean() < 0.03


@pytest.mark.parametrize("n_threads", [1, 4, 0])
def test_batches_equal_the_per_image_loop(images, n_threads):
    jpg, png, gray = images
    paths = [jpg, png, gray, jpg, png]
    ref = np.stack([tnative.load_eval(p, 84) for p in paths])
    np.testing.assert_array_equal(
        tnative.load_eval_batch(paths, 84, n_threads=n_threads), ref)
    canvas = np.stack([tnative.load_canvas(p, 96) for p in paths])
    assert canvas.dtype == np.uint8 and canvas.shape == (5, 96, 96, 3)
    np.testing.assert_array_equal(
        tnative.load_canvas_batch(paths, 96, n_threads=n_threads), canvas)


def test_canvas_matches_pil_and_known_pixels(images):
    jpg, png, gray = images
    paths = [jpg, png, gray]
    nat = tnative.load_canvas_batch(paths, 96)
    pil = np.stack([ttr.load_canvas(p, 96) for p in paths])
    diff = np.abs(nat.astype(int) - pil.astype(int))
    assert diff.max() <= 6 and diff.mean() < 1.0
    # at the PNG's own size the resampling is the identity: exact pixels
    exact = np.asarray(Image.open(png).convert("RGB"))
    assert exact.shape[0] != exact.shape[1]
    square = str(os.path.join(os.path.dirname(png), "sq.png"))
    Image.fromarray(exact[:, :100]).save(square)
    np.testing.assert_array_equal(tnative.load_canvas(square, 100),
                                  exact[:, :100])


def test_pipelines_equal_jax_and_stay_near_pil(images, tmp_path):
    """The port's TransformPipeline through its decoder equals the JAX
    package's through its own, eval and aug (the same draws); a format the
    decoder does not read (BMP) goes to PIL in both."""
    bmp = str(tmp_path / "t.bmp")
    Image.open(images[0]).save(bmp)
    paths = [*images, bmp]
    t = ttr.TransformPipeline(84, aug=False)
    assert t.use_native
    j = jtr.TransformPipeline(84, aug=False, output_uint8=True)
    np.testing.assert_array_equal(t.load_batch(paths), j.load_batch(paths))
    np.testing.assert_array_equal(t.load_batch(paths),
                                  np.stack([t.load(p) for p in paths]))
    pil = ttr.TransformPipeline(84, aug=False, use_native=False)
    diff = np.abs(t.load_batch(paths).astype(int)
                  - pil.load_batch(paths).astype(int))
    assert diff.max() / 255 / 0.229 < 0.02  # the JAX eval bound, in u8
    ta = ttr.TransformPipeline(84, aug=True, seed=3)
    ja = jtr.TransformPipeline(84, aug=True, seed=3, output_uint8=True)
    for p in paths * 2:
        np.testing.assert_array_equal(ta.load(p), ja.load(p))


def _filelist(tmp_path, names):
    jf = str(tmp_path / "split.json")
    with open(jf, "w") as f:
        json.dump({"label_names": ["a", "b"], "image_names": names,
                   "image_labels": [i % 2 for i in range(len(names))]}, f)
    return jf


@pytest.mark.parametrize("canvas", [False, True])
def test_staged_split_equals_jax_staging(images, tmp_path, monkeypatch,
                                         canvas):
    monkeypatch.setenv("DKT_NO_STAGE_CACHE", "1")
    monkeypatch.setattr(tdd, "STAGE_CHUNK", 3)  # two decode calls
    jf = _filelist(tmp_path, [*images, *images])
    tds = tdd.DeviceDataset(jf, 16, canvas=canvas, device="cpu")
    assert tds.decoder == "native decoder" and not tds.from_cache
    jds = jdd.DeviceDataset(jf, 16, canvas=canvas)
    np.testing.assert_array_equal(tds.images.numpy(), np.asarray(jds.images))


def test_decoder_reports_a_failed_build(images, tmp_path, monkeypatch,
                                        capsys):
    """A source that does not compile: available() is False, the reason
    is printed once, no library is left, and the pipeline takes PIL."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    assert not tnative.available() and not tnative.available()
    out = capsys.readouterr().out
    assert out.count("did not build; decoding with PIL") == 1
    assert os.listdir(tmp_path / "_build") == []
    assert not ttr.TransformPipeline(16, aug=False).use_native
    with pytest.raises(RuntimeError, match="did not build"):
        tnative.load_eval(images[0], 16)


def test_failed_file_names_its_path(images, tmp_path):
    bad = str(tmp_path / "nope.jpg")
    with pytest.raises(IOError, match="nope"):
        tnative.load_eval_batch([images[0], bad, images[1]], 84)
    with pytest.raises(IOError, match="nope"):
        tnative.load_canvas(bad, 32)


def test_import_builds_nothing():
    code = ("import deep_kernel_transfer_tpu_torch.native as n; "
            "import deep_kernel_transfer_tpu_torch.data.device_dataset; "
            "assert n._lib is None and not n._build_failed; print('OK')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
