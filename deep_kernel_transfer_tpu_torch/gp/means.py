"""Constant mean (gpytorch ConstantMean, reference methods/DKT.py:349).

Port of deep_kernel_transfer_tpu/gp/means.py."""
from __future__ import annotations

import torch


def constant_mean_init(device=None) -> dict:
    return {"constant": torch.zeros((), device=device)}


def constant_mean(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The constant over the inputs: params [...], x [..., N, D] -> [..., N]
    (the constant's batch dims broadcast against x's)."""
    c = params["constant"][..., None]
    return c.expand(torch.broadcast_shapes(c.shape, x.shape[:-1]))
