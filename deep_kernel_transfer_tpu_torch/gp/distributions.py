"""Multivariate-normal container for GP priors and posteriors.

Port of deep_kernel_transfer_tpu/gp/distributions.py (replaces gpytorch's
MultivariateNormal as the reference consumes it)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MultivariateNormal(NamedTuple):
    mean: torch.Tensor  # [..., N]
    variance: torch.Tensor  # [..., N] marginal variances
    covariance: Optional[torch.Tensor] = None  # [..., N, N] if materialised
