"""Exact-GP engine (port of deep_kernel_transfer_tpu/gp, linear family)."""
from .distributions import MultivariateNormal
from .exact import ExactGP, batched_posterior, init_batched, psd_safe_cholesky, sum_mll
from .kernels import make_kernel, normalizes_features
from .likelihoods import GaussianLikelihood

__all__ = ["ExactGP", "GaussianLikelihood", "MultivariateNormal",
           "batched_posterior", "init_batched", "make_kernel",
           "normalizes_features", "psd_safe_cholesky", "sum_mll"]
