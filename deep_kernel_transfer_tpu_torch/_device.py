"""Device selection shared by the port's entry points."""
from __future__ import annotations

import functools
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA, and raises when there is
    no CUDA device (the port never falls back to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A small constant tensor, copied to `device` once a process: a copy
    from pageable host memory on every call blocks the host until the card
    has caught up, and the card then idles while the host works. Shared
    by every caller, so never written to in place (tests/
    test_torch_device_aug.py holds the callers to that)."""
    return torch.tensor(values, dtype=dtype, device=device)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, for every number kept."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
