"""Multivariate-normal container for GP priors and posteriors.

Port of deep_kernel_transfer_tpu/gp/distributions.py (replaces gpytorch's
MultivariateNormal as the reference consumes it: mean, variance,
confidence_region, samples; reference methods/DKT_regression.py:93,
sines/train_DKT.py:248)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MultivariateNormal(NamedTuple):
    mean: torch.Tensor  # [..., N]
    variance: torch.Tensor  # [..., N] marginal variances
    covariance: Optional[torch.Tensor] = None  # [..., N, N] if materialised

    @property
    def stddev(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.variance, min=0.0))

    def confidence_region(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Two standard deviations below and above the mean, as gpytorch's
        confidence_region()."""
        half = 2.0 * self.stddev
        return self.mean - half, self.mean + half

    def sample(self, num_samples: int, generator=None) -> torch.Tensor:
        """[num_samples, ..., N] draws: through the jittered Cholesky of
        the covariance when it is materialised (a posterior covariance can
        round slightly indefinite in f32), else from the marginals (JAX
        distributions.py:38-57). The normals come from `generator`."""
        gen_device = (self.mean.device if generator is None
                      else generator.device)
        eps = torch.randn((num_samples,) + tuple(self.mean.shape),
                          generator=generator, device=gen_device,
                          dtype=self.mean.dtype).to(self.mean.device)
        if self.covariance is None:
            return self.mean + self.stddev * eps
        from .exact import psd_safe_cholesky
        from .kernels import full_f32

        chol = psd_safe_cholesky(self.covariance)
        with full_f32():
            return self.mean + torch.einsum("...ij,s...j->s...i", chol, eps)
