"""The host's native image decoder: decode and transform in C++.

Port of deep_kernel_transfer_tpu/native/__init__.py. `csrc/image_pipeline.cc`
(a byte-for-byte copy of the JAX package's `native/src/image_pipeline.cc`)
compiles at first use with the JAX package's command line, g++ -O3
-march=native, linked against libjpeg and libpng, into the package's
gitignored `_build/`, named by a hash of the source and the command, and
is loaded with ctypes. Importing this module builds nothing.

Where the compiler or the image libraries are missing the build fails,
`available()` is False and the callers decode with PIL, as the JAX package
does (data/transforms.py, data/device_dataset.py). The first call of a
process prints which decoder it got, so a run's log says which one
staged its splits. This is host code; no device kernel is involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "image_pipeline.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libdkt_data-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> Optional[str]:
    """Compile to a per-process temporary path, then rename it into place:
    several processes (test workers, ranks) may build at once, and rename
    is atomic, so none loads a half-written file. Returns None, or why the
    build failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        result = subprocess.run(cmd, capture_output=True, text=True,
                                timeout=120)
        if result.returncode != 0:
            return result.stderr.strip()[-2000:]
        os.replace(tmp, out)
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        lib, why = None, None
        for attempt in range(2):
            if attempt or not path.exists():
                why = _build(path)
                if why is not None:
                    break
            try:
                lib, why = ctypes.CDLL(str(path)), None
                break
            except OSError as e:  # e.g. built on another machine: rebuild
                why = str(e)
        if lib is None:
            _build_failed = True
            print(f"[native] the image decoder did not build; decoding with "
                  f"PIL:\n{why}", flush=True)
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        cint, cstr = ctypes.c_int, ctypes.c_char_p
        cfloat = ctypes.c_float
        sigs = {
            "dkt_image_size": [cstr, ctypes.POINTER(cint),
                               ctypes.POINTER(cint)],
            "dkt_load_eval": [cstr, cint, cint, fp],
            "dkt_load_aug": [cstr, cint, cint, cint, cint, cint, cint, cfloat,
                             cfloat, cfloat, cint, fp],
            "dkt_load_eval_batch": [ctypes.POINTER(cstr), cint, cint, cint,
                                    cint, fp],
            "dkt_load_canvas": [cstr, cint, u8p],
            "dkt_load_canvas_batch": [ctypes.POINTER(cstr), cint, cint, cint,
                                      u8p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = cint
        print(f"[native] image decoder: {path.name} (libjpeg, libpng)",
              flush=True)
        _lib = lib
        return _lib


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native image decoder did not build; check "
                           "available() first")
    return lib


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    return _load() is not None


def image_size(path: str) -> tuple[int, int]:
    """(width, height) from the file's header."""
    w, h = ctypes.c_int(), ctypes.c_int()
    if _need().dkt_image_size(path.encode(), ctypes.byref(w),
                              ctypes.byref(h)):
        raise IOError(f"native decode failed: {path}")
    return w.value, h.value


def _f32(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def load_eval(path: str, size: int, normalize: bool = True) -> np.ndarray:
    """Decode, Scale(1.15x), CenterCrop, [0, 1] or ImageNet-normalised:
    [size, size, 3] float32."""
    out = np.empty((size, size, 3), np.float32)
    if _need().dkt_load_eval(path.encode(), size, int(normalize), _f32(out)):
        raise IOError(f"native decode failed: {path}")
    return out


def load_eval_batch(paths: list[str], size: int, normalize: bool = True,
                    n_threads: int = 0) -> np.ndarray:
    """`load_eval` of many files on a C++ thread pool: [n, size, size, 3]
    float32. n_threads <= 0 takes every hardware thread; the result is the
    per-image loop's whatever the count."""
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.empty((n, size, size, 3), np.float32)
    rc = _need().dkt_load_eval_batch(arr, n, size, int(normalize),
                                     int(n_threads), _f32(out))
    if rc:
        raise IOError(f"native decode failed: {paths[rc - 1]}")
    return out


def load_canvas(path: str, size: int) -> np.ndarray:
    """The whole image resampled to a square canvas, no crop: [size, size,
    3] uint8, the DeviceDataset(canvas=True) staging format."""
    out = np.empty((size, size, 3), np.uint8)
    if _need().dkt_load_canvas(path.encode(), size, _u8(out)):
        raise IOError(f"native decode failed: {path}")
    return out


def load_canvas_batch(paths: list[str], size: int,
                      n_threads: int = 0) -> np.ndarray:
    """`load_canvas` of many files on the thread pool: [n, size, size, 3]
    uint8, the per-image loop's whatever the thread count."""
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.empty((n, size, size, 3), np.uint8)
    rc = _need().dkt_load_canvas_batch(arr, n, size, int(n_threads), _u8(out))
    if rc:
        raise IOError(f"native decode failed: {paths[rc - 1]}")
    return out


def load_aug(path: str, size: int, crop_box, jitter_factors, flip: bool,
             normalize: bool = True) -> np.ndarray:
    """The aug pipeline with its draws given: crop_box (left, top, w, h),
    or None for the centred-square fallback; jitter_factors (brightness,
    contrast, color); flip. [size, size, 3] float32."""
    left, top, cw, ch = crop_box if crop_box is not None else (0, 0, -1, -1)
    bright, contrast, color = jitter_factors
    out = np.empty((size, size, 3), np.float32)
    if _need().dkt_load_aug(path.encode(), size, int(normalize), left, top,
                            cw, ch, bright, contrast, color, int(flip),
                            _f32(out)):
        raise IOError(f"native decode failed: {path}")
    return out
