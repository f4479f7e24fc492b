"""Host-side image transforms of the reference pipeline, on PIL images.

Copy of the PIL path of deep_kernel_transfer_tpu/data/transforms.py
(reference data/datamgr.py:38-46, data/additional_transforms.py:15-28):

  aug:   RandomSizedCrop, ImageJitter, RandomHorizontalFlip
  eval:  Scale(1.15x), CenterCrop

emitting uint8 NHWC pixels, which the trunk normalises on the device
(models/backbones.py::preprocess_input). The JAX package's native C++
decoder is not ported (ROADMAP queue A, item 5). PIL is imported only
inside the functions that decode, so the device-data path, which reads
staged tensors, runs without it.
"""
from __future__ import annotations

import numpy as np

JITTER_PARAMS = dict(Brightness=0.4, Contrast=0.4, Color=0.4)
_BILINEAR = 2  # PIL.Image.BILINEAR
_FLIP_LEFT_RIGHT = 0  # PIL.Image.FLIP_LEFT_RIGHT


def _enhancer(name: str):
    from PIL import ImageEnhance

    return getattr(ImageEnhance, name)


def scale(img, size: int):
    """torchvision Scale([1.15*s, 1.15*s]) (reference data/datamgr.py:32)."""
    s = int(size * 1.15)
    return img.resize((s, s), _BILINEAR)


def center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def fallback_crop_box(w: int, h: int) -> tuple[int, int, int, int]:
    """The crop when all 10 RandomSizedCrop attempts fail: the centred
    min-side square."""
    m = min(w, h)
    return (w - m) // 2, (h - m) // 2, m, m


def sample_crop_box(w: int, h: int, rng: np.random.RandomState):
    """RandomSizedCrop's parameters: area in [0.08, 1], aspect in
    [3/4, 4/3], 10 attempts; (left, top, cw, ch), or None for the
    fallback."""
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(0.08, 1.0) * area
        aspect = np.exp(rng.uniform(np.log(3.0 / 4.0), np.log(4.0 / 3.0)))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            return left, top, cw, ch
    return None


class TransformPipeline:
    """aug/eval pipelines of reference data/datamgr.py:38-46, with the
    random draws from a numpy RandomState in the JAX package's order (crop
    box, jitter factors, flip), so a seed gives the same images."""

    def __init__(self, image_size: int, aug: bool, seed: int = 0):
        self.image_size = image_size
        self.aug = aug
        self.rng = np.random.RandomState(seed)

    def __call__(self, img) -> np.ndarray:
        if self.aug:
            w, h = img.size
            box = sample_crop_box(w, h, self.rng)
            rand = self.rng.rand(len(JITTER_PARAMS))
            factors = tuple(alpha * (rand[i] * 2.0 - 1.0) + 1
                            for i, alpha in enumerate(JITTER_PARAMS.values()))
            flip = bool(self.rng.rand() < 0.5)
            return self._apply_aug(img, box, factors, flip)
        img = scale(img, self.image_size)
        img = center_crop(img, self.image_size)
        return self._emit(img)

    def _emit(self, img) -> np.ndarray:
        return np.asarray(img.convert("RGB"), np.uint8)

    def _apply_aug(self, img, box, factors, flip: bool) -> np.ndarray:
        if box is None:
            box = fallback_crop_box(*img.size)
        left, top, cw, ch = box
        img = img.crop((left, top, left + cw, top + ch)).resize(
            (self.image_size, self.image_size), _BILINEAR)
        for name, r in zip(JITTER_PARAMS, factors):
            img = _enhancer(name)(img).enhance(r).convert("RGB")
        if flip:
            img = img.transpose(_FLIP_LEFT_RIGHT)
        return self._emit(img)

    def load(self, path: str) -> np.ndarray:
        """Decode and transform one file."""
        return self(load_image(path))

    def load_batch(self, paths: list[str]) -> np.ndarray:
        """Decode and transform many files: [n, size, size, 3]."""
        return np.stack([self.load(p) for p in paths])


def load_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def load_canvas(path: str, size: int) -> np.ndarray:
    """The whole image resized to a square canvas (the reference's Scale
    step with no crop, data/datamgr.py:32), uint8 HWC: what the on-device
    augmentation crops from (JAX device_dataset.py:426-430)."""
    return np.asarray(load_image(path).resize((size, size), _BILINEAR),
                      np.uint8)
