"""QMUL head-pose trajectory loader (reference data/qmul_loader.py).

Port of deep_kernel_transfer_tpu/data/qmul.py: a random sine "trajectory"
(amplitude in [-3, 3], phase in [-5, 5]) mapped onto the (pitch, yaw) grid
of face images; the targets are normalised pitches. Returns
[n_people, 19, H, W, C] float32 NHWC arrays from 100x100 RGB JPEGs named
<person>_<pitch>_<angle>.jpg. The draws are numpy's, on the host, so both
packages see the same trajectories under the same RandomState.
"""
from __future__ import annotations

import os

import numpy as np

from .lru import ByteCappedLRU
from .transforms import load_image

# the fixed person splits (reference data/qmul_loader.py:9-10)
train_people = [
    "DennisPNoGlassesGrey", "JohnGrey", "SimonBGrey", "SeanGGrey", "DanJGrey",
    "AdamBGrey", "JackGrey", "RichardHGrey", "YongminYGrey", "TomKGrey",
    "PaulVGrey", "DennisPGrey", "CarlaBGrey", "JamieSGrey", "KateSGrey",
    "DerekCGrey", "KatherineWGrey", "ColinPGrey", "SueWGrey", "GrahamWGrey",
    "KrystynaNGrey", "SeanGNoGlassesGrey", "KeithCGrey", "HeatherLGrey",
]
test_people = [
    "RichardBGrey", "TasosHGrey", "SarahLGrey", "AndreeaVGrey", "YogeshRGrey",
]

NUM_SAMPLES = 19  # points per trajectory


def num_to_str(num: int) -> str:
    """The file names' three-digit pitch and angle."""
    if num == 0:
        return "000"
    if num < 100:
        return "0" + str(int(num))
    return str(int(num))


def face_file(prefix: str, person: str, pitch: int, angle: int) -> str:
    return os.path.join(prefix, person, f"{person[:-4]}_{num_to_str(pitch)}"
                                        f"_{num_to_str(angle)}.jpg")


def sample_trajectory(rng: np.random.RandomState,
                      num_samples: int = NUM_SAMPLES):
    """A random sine curve as a list of (pitch, yaw) grid coordinates
    (reference data/qmul_loader.py:42-49)."""
    amp = rng.uniform(-3, 3)
    phase = rng.uniform(-5, 5)
    wave = [amp * np.sin(phase + x) for x in range(num_samples)]
    angles = [x * 10 for x in range(num_samples)]
    pitches = [int(round(((y + 3) * 10) + 60, -1)) for y in wave]
    return list(zip(pitches, angles))


def _default_prefix() -> str:
    """The reference layout first, then the repo's prep-script location."""
    for p in ("filelists/QMUL/images/", "filelists_tpu/QMUL/images/"):
        if os.path.isdir(p):
            return p
    return "filelists/QMUL/images/"


# decode cache: every epoch samples 19 of the same 13x19 grid a person, so
# a training run would decode each JPEG hundreds of times. uint8 keeps the
# 29-person grid at about 215 MB; DKT_QMUL_CACHE_BYTES caps it.
_DECODE_CACHE = ByteCappedLRU(
    int(os.environ.get("DKT_QMUL_CACHE_BYTES", 1 << 30)))


def _load_face(fname: str) -> np.ndarray:
    return _DECODE_CACHE.get_or_load(
        fname, lambda f: np.asarray(load_image(f), np.uint8))


def get_person_at_curve(person: str, curve, prefix: str | None = None):
    """One person's images along a trajectory, scaled to [0, 1] (no
    ImageNet normalisation: the reference uses a bare ToTensor), and the
    normalised pitches (reference data/qmul_loader.py:22-39)."""
    if prefix is None:
        prefix = _default_prefix()
    faces, targets = [], []
    for pitch, angle in curve:
        faces.append(_load_face(face_file(prefix, person, pitch, angle))
                     .astype(np.float32) / 255.0)
        targets.append(2 * ((pitch - 60) / (120 - 60)) - 1)
    return np.stack(faces), np.asarray(targets, np.float32)


def get_batch(people=train_people, rng: np.random.RandomState | None = None,
              num_samples: int = NUM_SAMPLES, prefix: str | None = None):
    """[n_people, 19, H, W, C] inputs and [n_people, 19] targets, every
    person along one trajectory (reference data/qmul_loader.py:41-59)."""
    if rng is None:
        rng = np.random.RandomState()
    curve = sample_trajectory(rng, num_samples)
    inputs, targets = [], []
    for person in people:
        inps, targs = get_person_at_curve(person, curve, prefix)
        inputs.append(inps)
        targets.append(targs)
    return np.stack(inputs), np.stack(targets)
