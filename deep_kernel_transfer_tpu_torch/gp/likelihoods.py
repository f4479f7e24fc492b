"""Gaussian observation likelihood (gpytorch GaussianLikelihood).

Port of deep_kernel_transfer_tpu/gp/likelihoods.py: trainable noise
(raw init 0, noise = softplus(0), the regression setting) or a fixed noise
kept out of the params (0.1 for classification, reference
methods/DKT.py:346-347)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .distributions import MultivariateNormal
from .kernels import inv_softplus, softplus


class GaussianLikelihood(NamedTuple):
    trainable: bool = True
    fixed_noise: float = 0.1

    def init(self, noise: float | None = None, device=None) -> dict:
        if not self.trainable:
            if noise is not None and float(noise) != float(self.fixed_noise):
                raise ValueError(
                    f"init(noise={noise}) on a non-trainable likelihood with "
                    f"fixed_noise={self.fixed_noise}: construct "
                    "GaussianLikelihood(trainable=False, fixed_noise=noise) "
                    "instead")
            return {}
        if noise is None:
            return {"raw_noise": torch.zeros((), device=device)}
        return {"raw_noise": inv_softplus(
            torch.tensor(noise, dtype=torch.float32, device=device))}

    def noise(self, params: dict) -> torch.Tensor | float:
        """The noise variance: a float when fixed, else a tensor."""
        if not self.trainable:
            return float(self.fixed_noise)
        return softplus(params["raw_noise"])

    def __call__(self, params: dict,
                 dist: MultivariateNormal) -> MultivariateNormal:
        """p(y|f): adds the observation noise to the variances."""
        n = self.noise(params)
        cov = dist.covariance
        if cov is not None:
            eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
            cov = cov + torch.as_tensor(n, device=cov.device)[..., None, None] * eye
        return MultivariateNormal(dist.mean, dist.variance + torch.as_tensor(
            n, device=dist.variance.device)[..., None], cov)
