"""Device selection shared by the port's entry points."""
from __future__ import annotations

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


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, for every number kept."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]
