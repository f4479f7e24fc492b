"""The port's on-device augmentation (deep_kernel_transfer_tpu_torch/data/
device_aug.py) against the JAX package's where its law is deterministic:
the crop-resize for fixed boxes (jax.image.scale_and_translate, linear,
antialiased) with up- and down-scaling and boxes at the canvas edge, and
the jitter chain for fixed factors, within 1e-3 on [0, 255]. Then the
random parts: the crop boxes' law, and `augment`'s dtype, shape and flip.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deep_kernel_transfer_tpu.data import device_aug as jaug
from deep_kernel_transfer_tpu_torch.data import device_aug as taug
from torch_test_threads import one_thread  # noqa: F401

CANVAS = 32


def _images(n, size=CANVAS, seed=0):
    """Smooth gradients plus noise, float32 in [0, 255]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = np.stack([yy * 7, xx * 5, (yy + xx) * 3], -1) % 255
    return np.clip(base[None] + rng.rand(n, size, size, 3) * 40, 0,
                   255).astype(np.float32)


# (left, top, cw, ch): down-scaling, up-scaling, mixed, at each edge, the
# whole canvas, a 1-pixel box
BOXES = [(3, 5, 24, 20), (10, 12, 9, 7), (0, 0, 30, 8), (20, 0, 12, 32),
         (0, 17, 32, 15), (31, 31, 1, 1), (0, 0, 32, 32), (6, 2, 14, 27)]


@pytest.mark.parametrize("out_size", [16, 28])
def test_crop_resize_matches_jax(out_size):
    imgs = _images(len(BOXES))
    left, top, cw, ch = (np.array(v, np.float32) for v in zip(*BOXES))
    got = taug.crop_resize(torch.from_numpy(imgs), *(torch.from_numpy(v)
                           for v in (left, top, cw, ch)), out_size).numpy()
    assert got.shape == (len(BOXES), out_size, out_size, 3)
    for i in range(len(BOXES)):
        want = np.asarray(jaug._crop_resize(
            jnp.asarray(imgs[i]), left[i], top[i], cw[i], ch[i], out_size))
        assert np.abs(got[i] - want).max() < 1e-3, BOXES[i]


def test_apply_jitter_matches_jax():
    imgs = _images(6, 16)
    rng = np.random.RandomState(1)
    factors = (1.0 + 0.4 * (2 * rng.rand(6, 3) - 1)).astype(np.float32)
    factors[0] = (0.6, 1.4, 0.6)  # the ends of the law
    factors[1] = (1.4, 0.6, 1.4)
    got = taug.apply_jitter(torch.from_numpy(imgs),
                            torch.from_numpy(factors)).numpy()
    for i in range(6):
        want = np.asarray(jaug.apply_jitter(jnp.asarray(imgs[i]),
                                            jnp.asarray(factors[i])))
        assert np.abs(got[i] - want).max() < 1e-3


def test_crop_boxes_law():
    gen = torch.Generator().manual_seed(0)
    left, top, cw, ch = taug.sample_crop_boxes(gen, 4000, CANVAS, 28, "cpu")
    assert (cw >= 1).all() and (ch >= 1).all()
    assert (left >= 0).all() and (top >= 0).all()
    assert (left + cw <= CANVAS).all() and (top + ch <= CANVAS).all()
    area = (cw * ch / CANVAS ** 2).numpy()
    aspect = (cw / ch).numpy()
    # rounding to whole pixels widens the law's ends a little
    assert area.min() > 0.06 and area.max() <= 1.0
    assert aspect.min() > 0.7 and aspect.max() < 1.43
    assert 0.45 < area.mean() < 0.6  # E[U(0.08, 1)] = 0.54, less clipping


def test_augment_dtype_shape_and_flip():
    """augment = crop-resize, jitter, flip, round: rebuilt from the same
    generator draws, it gives the same uint8 images; each image is flipped
    or not by its own draw, about half of them."""
    imgs = torch.from_numpy(_images(2 * 3 * 40)).round().to(torch.uint8)
    x = imgs.reshape(2, 3, 40, CANVAS, CANVAS, 3)
    out = taug.augment(torch.Generator().manual_seed(5), x, 28)
    assert out.shape == (2, 3, 40, 28, 28, 3) and out.dtype == torch.uint8

    gen = torch.Generator().manual_seed(5)
    n = imgs.shape[0]
    boxes = taug.sample_crop_boxes(gen, n, CANVAS, 28, "cpu")
    plain = taug.crop_resize(imgs.float(), *boxes, 28)
    alphas = torch.tensor([0.4, 0.4, 0.4])
    plain = taug.apply_jitter(plain, alphas * (torch.rand(
        n, 3, generator=gen) * 2 - 1) + 1)
    flip = torch.rand(n, generator=gen) < 0.5
    plain = torch.clamp(torch.round(plain), 0, 255).to(torch.uint8)
    out = out.reshape(n, 28, 28, 3)
    assert torch.equal(out[~flip], plain[~flip])
    assert torch.equal(out[flip], plain[flip].flip(2))
    assert 0.35 < float(flip.float().mean()) < 0.65


def test_weight_matrix_rows_sum_to_one_inside():
    """Every output sample inside the canvas has weights summing to 1; the
    filter widens by 1/scale when downscaling; upscaling interpolates at
    the sample's position (i + 0.5) / scale + start - 0.5."""
    start = torch.tensor([0.0, 4.0])
    length = torch.tensor([32.0, 8.0])
    w = taug.weight_matrix(start, length, 16, CANVAS)
    assert torch.allclose(w.sum(-1), torch.ones(2, 16), atol=1e-6)
    taps = (w > 0).sum(-1)
    assert int(taps[0].max()) >= 3 and int(taps[1].max()) <= 2
    centre = (w[1] * torch.arange(CANVAS, dtype=torch.float32)).sum(-1)
    want = (torch.arange(16, dtype=torch.float32) + 0.5) * 0.5 + 3.5
    assert torch.allclose(centre, want, atol=1e-5)


def test_constants_are_made_once():
    """The feed's and the trunk's small constants come from one tensor a
    (values, dtype, device): a copy from the host on every call would make
    the host wait for the card once a step."""
    from deep_kernel_transfer_tpu_torch._device import constant
    from deep_kernel_transfer_tpu_torch.models.backbones import (
        IMAGENET_MEAN, preprocess_input)

    cpu = torch.device("cpu")
    a = constant((1.0, 2.0), torch.float32, cpu)
    assert a is constant((1.0, 2.0), torch.float32, cpu)
    assert a.tolist() == [1.0, 2.0] and a.dtype == torch.float32
    assert constant((1.0, 2.0), torch.float64, cpu) is not a
    x = torch.randint(0, 256, (2, 4, 4, 3), dtype=torch.uint8)

    def step():  # the jitter's two luma weights, its factors, mean, std
        taug.augment(torch.Generator().manual_seed(0), x[None], 4)
        preprocess_input(x)

    step()
    before = constant.cache_info()
    step()
    after = constant.cache_info()
    assert after.misses == before.misses
    assert after.hits - before.hits == 5
    assert constant(IMAGENET_MEAN, torch.float32, cpu).tolist() == \
        pytest.approx(IMAGENET_MEAN)


def test_no_caller_writes_a_shared_constant():
    """Every caller shares the one tensor, so none may write to it: the
    version counter of each constant the feed and the trunk use stays at
    0 (an in-place op raises it) over an augmented batch, a preprocessed
    one and a train step."""
    from deep_kernel_transfer_tpu_torch._device import constant
    from deep_kernel_transfer_tpu_torch.data.transforms import JITTER_PARAMS
    from deep_kernel_transfer_tpu_torch.methods.dkt import DKT
    from deep_kernel_transfer_tpu_torch.models.backbones import (
        IMAGENET_MEAN, IMAGENET_STD, Conv4)

    cpu = torch.device("cpu")
    x = torch.randint(0, 256, (1, 2, 2, 16, 16, 3), dtype=torch.uint8)
    taug.augment(torch.Generator().manual_seed(0), x[0], 16)
    model = DKT(Conv4(), 2, 1, kernel_type="bncossim", device="cpu").init(
        x[0], torch.Generator().manual_seed(0))
    model.train_step(x)
    shared = [constant(taug._LUMA_W, torch.float32, cpu),
              constant(tuple(JITTER_PARAMS.values()),
                       torch.get_default_dtype(), cpu),
              constant(IMAGENET_MEAN, torch.float32, cpu),
              constant(IMAGENET_STD, torch.float32, cpu)]
    assert [t._version for t in shared] == [0, 0, 0, 0]
    assert shared[2].tolist() == pytest.approx(IMAGENET_MEAN)
    assert shared[3].tolist() == pytest.approx(IMAGENET_STD)
