"""Host-side image transforms of the reference pipeline, on PIL images.

Copy of the PIL path of deep_kernel_transfer_tpu/data/transforms.py
(reference data/datamgr.py:38-46, data/additional_transforms.py:15-28):

  aug:   RandomSizedCrop, ImageJitter, RandomHorizontalFlip
  eval:  Scale(1.15x), CenterCrop

emitting uint8 NHWC pixels, which the trunk normalises on the device
(models/backbones.py::preprocess_input). Where the native C++ decoder
builds (`native/`), `TransformPipeline.load` and `load_batch` decode and
transform in one native pass, as the JAX package's do; else PIL. PIL is
imported only inside the functions that decode, so the device-data path,
which reads staged tensors, runs without it.
"""
from __future__ import annotations

import numpy as np

from .. import native

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
    box, jitter factors, flip), so a seed gives the same images whichever
    decoder runs. `use_native` None takes the native decoder when it
    builds (JAX transforms.py:105-185); False forces PIL."""

    def __init__(self, image_size: int, aug: bool, seed: int = 0,
                 use_native: bool | None = None):
        self.image_size = image_size
        self.aug = aug
        self.rng = np.random.RandomState(seed)
        if use_native is None:
            use_native = native.available()
        self.use_native = use_native

    def __call__(self, img) -> np.ndarray:
        if self.aug:
            w, h = img.size
            return self._apply_aug(img, *self._draw_aug_params(w, h))
        img = scale(img, self.image_size)
        img = center_crop(img, self.image_size)
        return self._emit(img)

    def _emit(self, img) -> np.ndarray:
        return np.asarray(img.convert("RGB"), np.uint8)

    def _draw_aug_params(self, w: int, h: int):
        """The aug draws (crop box, jitter factors, flip) in the stream
        order both decoders share."""
        box = sample_crop_box(w, h, self.rng)
        rand = self.rng.rand(len(JITTER_PARAMS))
        factors = tuple(alpha * (rand[i] * 2.0 - 1.0) + 1
                        for i, alpha in enumerate(JITTER_PARAMS.values()))
        flip = bool(self.rng.rand() < 0.5)
        return box, factors, flip

    def _apply_aug(self, img, box, factors, flip: bool) -> np.ndarray:
        """The drawn aug parameters applied through PIL (no draw)."""
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
        """Decode and transform one file (natively where the decoder
        builds; a format it does not read goes to PIL)."""
        if not self.use_native:
            return self(load_image(path))
        if not self.aug:
            try:
                return _to_uint8(native.load_eval(path, self.image_size,
                                                  normalize=False))
            except IOError:
                return self(load_image(path))
        from PIL import Image

        try:
            with Image.open(path) as img:  # the header's size only
                w, h = img.size
        except IOError:
            return self(load_image(path))  # no draw made yet
        box, factors, flip = self._draw_aug_params(w, h)
        if box is None:
            box = fallback_crop_box(w, h)
        try:
            return _to_uint8(native.load_aug(path, self.image_size, box,
                                             factors, flip, normalize=False))
        except IOError:
            # PIL with the same draws: a second draw would move the stream
            # away from a PIL-only host's
            return self._apply_aug(load_image(path), box, factors, flip)

    def load_batch(self, paths: list[str]) -> np.ndarray:
        """Decode and transform many files: [n, size, size, 3]. The eval
        pipeline goes to the native decoder's thread pool in one call; aug
        stays a file at a time, its draws coming from the RandomState.
        Equal to a `load` loop."""
        if self.use_native and not self.aug and paths:
            try:
                return _to_uint8(native.load_eval_batch(
                    paths, self.image_size, normalize=False))
            except IOError:
                pass  # a file it does not read: a file at a time below
        return np.stack([self.load(p) for p in paths])


def _to_uint8(arr: np.ndarray) -> np.ndarray:
    """The native decoder's [0, 1] float32 as uint8 (JAX
    transforms.py:227-230)."""
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def load_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def load_canvas(path: str, size: int) -> np.ndarray:
    """The whole image resized to a square canvas (the reference's Scale
    step with no crop, data/datamgr.py:32), uint8 HWC, through PIL: what
    the on-device augmentation crops from (JAX device_dataset.py:426-430)."""
    return np.asarray(load_image(path).resize((size, size), _BILINEAR),
                      np.uint8)


def load_canvas_batch(paths: list[str], size: int) -> np.ndarray:
    """`load_canvas` of many files: one call to the native decoder's thread
    pool where it builds, else PIL a file at a time (JAX
    device_dataset.py:433-446)."""
    if native.available() and paths:
        try:
            return native.load_canvas_batch(paths, size)
        except IOError:
            pass  # a file it does not read: PIL below
    return np.stack([load_canvas(p, size) for p in paths])
