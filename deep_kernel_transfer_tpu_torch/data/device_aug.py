"""On-device augmentation: RandomSizedCrop + ImageJitter + horizontal flip
of uint8 canvases resident in device memory, batched over every image.

Port of deep_kernel_transfer_tpu/data/device_aug.py (reference
data/datamgr.py:38-43, data/additional_transforms.py:15-28), on the square
int(1.15 * image_size) canvases of DeviceDataset(canvas=True):

  * RandomSizedCrop: area in [0.08, 1] of the canvas, aspect in [3/4, 4/3],
    10 draws with the first valid one taken, else the centred out_size
    window.
  * The crop is resized as jax.image.scale_and_translate(method="linear")
    does it: a triangle filter over the whole canvas, widened by 1/scale
    when downscaling (antialiasing), each output sample's weights
    renormalised, a sample outside the canvas zero. Per image that is a
    row and a column weight matrix [out, canvas] (`weight_matrix`), applied
    as two batched f32 products with TF32 off (F.interpolate of the
    cropped tensor follows another law, and TF32 would flip uint8 values
    after rounding).
  * ImageJitter: PIL ImageEnhance's Brightness (towards black), Contrast
    (towards the rounded mean of the luma) and Color (towards the luma),
    factors alpha (2u - 1) + 1, alpha = 0.4, in that order.
  * Flip with p = 0.5, then round half to even and clip to uint8.

Draws come from a `torch.Generator` on the device, not from jax.random.
"""
from __future__ import annotations

import math

import torch

from .._device import constant
from ..gp.kernels import full_f32
from .transforms import JITTER_PARAMS

# PIL's ITU-R 601-2 luma transform (Image.convert("L"))
_LUMA_W = (0.299, 0.587, 0.114)


def sample_crop_boxes(gen: torch.Generator, n: int, canvas: int,
                      out_size: int, device) -> tuple[torch.Tensor, ...]:
    """Vectorised 10-attempt RandomSizedCrop: (left, top, cw, ch), each
    float32 [n] (JAX device_aug.py:40-71)."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, 10, generator=gen,
                                           device=device)

    target = uniform(0.08, 1.0) * (canvas * canvas)
    aspect = torch.exp(uniform(math.log(3.0 / 4.0), math.log(4.0 / 3.0)))
    cw = torch.round(torch.sqrt(target * aspect))
    ch = torch.round(torch.sqrt(target / aspect))
    valid = (cw > 0) & (cw <= canvas) & (ch > 0) & (ch <= canvas)
    idx = torch.argmax(valid.to(torch.int8), dim=1, keepdim=True)  # first
    any_valid = valid.any(dim=1)
    cw = cw.gather(1, idx)[:, 0]
    ch = ch.gather(1, idx)[:, 0]
    u_left = torch.rand(n, 10, generator=gen, device=device).gather(1, idx)
    u_top = torch.rand(n, 10, generator=gen, device=device).gather(1, idx)
    left = torch.floor(u_left[:, 0] * (canvas - cw + 1))
    top = torch.floor(u_top[:, 0] * (canvas - ch + 1))
    # the host law falls back to the original image's centred square; the
    # canvas is square already, so the fallback is the centred window
    off = float((canvas - out_size) // 2)
    size = torch.full_like(cw, float(out_size))
    return (torch.where(any_valid, left, off), torch.where(any_valid, top, off),
            torch.where(any_valid, cw, size), torch.where(any_valid, ch, size))


def weight_matrix(start: torch.Tensor, length: torch.Tensor, out_size: int,
                  in_size: int) -> torch.Tensor:
    """[n, out_size, in_size] resampling weights of a crop [start, start +
    length) of an axis of in_size pixels to out_size pixels, as
    jax.image.scale_and_translate's compute_weight_mat builds them for
    method="linear", antialias=True (scale out/length, translation
    -start*out/length)."""
    dev = start.device
    inv_scale = (length / out_size)[:, None, None]              # [n, 1, 1]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = (i[None, :, None] + 0.5) * inv_scale + start[:, None, None] - 0.5
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(sample - j) / kernel_scale, min=0.0)
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)       # [n, out, 1]
    return torch.where(inside, w, 0.0)


def crop_resize(images: torch.Tensor, left, top, cw, ch,
                out_size: int) -> torch.Tensor:
    """Bilinear (antialiased) crop-resize of float images [n, H, W, C] to
    [n, out_size, out_size, C] (JAX device_aug.py:74-80)."""
    n, h, w, c = images.shape
    rows = weight_matrix(top, ch, out_size, h)                  # [n, o, H]
    cols = weight_matrix(left, cw, out_size, w)                 # [n, o, W]
    with full_f32():
        t = torch.bmm(rows, images.reshape(n, h, w * c))        # [n, o, W*C]
        t = t.reshape(n, out_size, w, c).transpose(2, 3).reshape(
            n, out_size * c, w)                                 # [n, o*C, W]
        out = torch.bmm(t, cols.transpose(1, 2))                # [n, o*C, o]
    return out.reshape(n, out_size, c, out_size).transpose(2, 3)


def _luma(images: torch.Tensor) -> torch.Tensor:
    w = constant(_LUMA_W, images.dtype, images.device)
    return torch.sum(images * w, dim=-1)


def apply_jitter(images: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """PIL's ImageEnhance chain on float images [n, H, W, 3] in [0, 255],
    `factors` [n, 3] in JITTER_PARAMS order (JAX device_aug.py:83-98)."""
    for i, name in enumerate(JITTER_PARAMS):
        f = factors[:, i, None, None, None]
        if name == "Brightness":
            degenerate = torch.zeros_like(images)
        elif name == "Contrast":
            degenerate = torch.round(_luma(images).mean(dim=(1, 2)))[
                :, None, None, None].expand_as(images)
        else:  # Color
            degenerate = _luma(images)[..., None].expand_as(images)
        images = torch.clamp(degenerate * (1.0 - f) + images * f, 0.0, 255.0)
    return images


def draw_augment(gen: torch.Generator, n: int, canvas: int, out_size: int,
                 device) -> tuple[torch.Tensor, ...]:
    """The draws of `augment` for n images, in its order: the crop boxes
    (left, top, cw, ch), the jitter factors [n, 3] and the flips [n], each
    with a leading [n] axis, so that a slice of them is the draws of a
    slice of the images."""
    box = sample_crop_boxes(gen, n, canvas, out_size, device)
    alphas = constant(tuple(JITTER_PARAMS.values()), torch.get_default_dtype(),
                      torch.device(device))
    u = torch.rand(n, len(JITTER_PARAMS), generator=gen, device=device)
    flip = torch.rand(n, generator=gen, device=device) < 0.5
    return (*box, alphas * (u * 2.0 - 1.0) + 1.0, flip)


def apply_augment(images_u8: torch.Tensor, draws: tuple[torch.Tensor, ...],
                  out_size: int) -> torch.Tensor:
    """[..., canvas, canvas, 3] uint8 -> [..., out_size, out_size, 3] uint8
    under `draw_augment`'s draws, one for each image in order."""
    lead = images_u8.shape[:-3]
    flat = images_u8.reshape((-1,) + tuple(images_u8.shape[-3:])).to(
        torch.float32)
    left, top, cw, ch, factors, flip = draws
    out = crop_resize(flat, left, top, cw, ch, out_size)
    out = apply_jitter(out, factors)
    out = torch.where(flip[:, None, None, None], out.flip(2), out)
    out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.reshape(tuple(lead) + (out_size, out_size, 3))


def augment(gen: torch.Generator, images_u8: torch.Tensor,
            out_size: int) -> torch.Tensor:
    """[..., canvas, canvas, 3] uint8 -> [..., out_size, out_size, 3] uint8,
    each image with its own crop, jitter and flip (JAX
    device_aug.py:108-129)."""
    n = math.prod(images_u8.shape[:-3])
    return apply_augment(images_u8, draw_augment(
        gen, n, images_u8.shape[-3], out_size, images_u8.device), out_size)
