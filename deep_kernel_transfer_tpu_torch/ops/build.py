"""Build the package's CUDA kernels with nvcc and load them with ctypes.

`csrc/<name>.cu` compiles into a shared library with a plain C interface
(`nvcc -shared`, no PyTorch headers, so a build takes seconds), linked
against libcuda for its TMA tensor maps (`-lcuda`). The library
goes to `_build/` inside the package, named by a hash of its source and of
the shared headers `csrc/*.cuh`, so an edited source never loads a stale
library. Building happens at first use; `build_all` starts one nvcc per
source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names) -> dict[str, tuple[Path, str]]:
    """Compile each `csrc/<name>.cu` that is not built already, one nvcc
    per source, all started together. Returns name -> (library path, nvcc's
    output: its register and shared-memory report, empty when nothing was
    built); raises on a failed build."""
    procs, done = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            done[name] = (out, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (out, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build(name: str) -> tuple[Path, str]:
    """`build_all` of one source."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        _loaded[name] = lib
    return lib


def error_name(code: int) -> str:
    """A kernel entry point's return code: a cudaError_t, or minus the
    CUresult of a failed tensor-map encoding."""
    return (f"CUresult {-code}" if code < 0 else f"CUDA error {code}")
