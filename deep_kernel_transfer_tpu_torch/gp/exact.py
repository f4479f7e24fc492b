"""ExactGP engine: jittered Cholesky, marginal log-likelihood, posterior.

Port of deep_kernel_transfer_tpu/gp/exact.py (the replacement for the
GPyTorch ExactGP + ExactMarginalLogLikelihood machinery of reference
methods/DKT.py:58-71). Everything is a function of (params, data), and
batching is broadcasting: params leaves may carry a leading way axis [W]
and inputs leading episode axes, so one call factors every [.., W, N, N]
Gram at once.

Two routes, as in the JAX package (exact.py:194-256): a kernel that is
exactly low-rank (the linear family) takes the Woodbury route of
gp/low_rank.py when its feature width D' satisfies 2D' <= N, unless
force_dense is set; every other call factors the dense N x N Gram. The
TPU-compiler padding of exact.py:102-120 is not needed here.
"""
from __future__ import annotations

from typing import NamedTuple

import os

import torch

from .._device import resolve_device
from .distributions import MultivariateNormal
from .kernels import Kernel, dot_f32
from .likelihoods import GaussianLikelihood
from .means import constant_mean, constant_mean_init

_LOG_2PI = 1.8378770664093453


def _cholesky_or_nan(mat: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky that gives NaN for a non-PD matrix, as jnp does
    (torch.linalg.cholesky raises instead)."""
    chol, info = torch.linalg.cholesky_ex(mat)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def psd_safe_cholesky(mat: torch.Tensor, initial_jitter: float = 1e-6,
                      max_tries: int = 9) -> torch.Tensor:
    """Cholesky with jitter escalation, per matrix of the batch.

    Each matrix that does not factor is retried with jitter
    initial_jitter * 10**i, i = 0 .. max_tries-1; on exhaustion the next
    untried level is used (gpytorch would raise; a NaN factor is the
    in-graph analogue, as in the JAX package). The search runs on a
    detached copy; one differentiable factorisation at the chosen jitter
    follows."""
    n = mat.shape[-1]
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    m0 = mat.detach()
    chol, info = torch.linalg.cholesky_ex(m0)
    bad = (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))
    jitter = torch.zeros(mat.shape[:-2], dtype=mat.dtype, device=mat.device)
    for i in range(max_tries):
        if not bool(bad.any()):
            break
        level = initial_jitter * 10.0 ** i
        chol, info = torch.linalg.cholesky_ex(m0 + level * eye)
        ok = (info == 0) & torch.isfinite(chol).all(dim=(-2, -1))
        jitter = torch.where(bad, torch.full_like(jitter, level), jitter)
        bad = bad & ~ok
    jitter = torch.where(bad, torch.full_like(
        jitter, initial_jitter * 10.0 ** max_tries), jitter)
    return _cholesky_or_nan(mat + jitter[..., None, None] * eye)


def _noisy(k: torch.Tensor, noise) -> torch.Tensor:
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    if isinstance(noise, torch.Tensor):
        noise = noise[..., None, None]
    return k + noise * eye


class ExactGP(NamedTuple):
    """A GP prior spec = (kernel, likelihood), pure configuration.

    Params are a dict {"mean": ..., "kernel": ..., "likelihood": ...} made
    by `init` (ExactGPLayer, reference methods/DKT.py:337-378).

    assume_pd skips the jitter search when the noisy Gram is PD by
    construction (a PSD kernel plus a fixed noise >= 1e-2): one plain
    factorisation, with the same result (JAX exact.py:139-153).
    force_dense keeps a low-rank kernel on the dense route (JAX
    exact.py:138); methods set it once, at construction."""

    kernel: Kernel
    likelihood: GaussianLikelihood
    assume_pd: bool = False
    force_dense: bool = False

    def _factor(self, k_noisy: torch.Tensor) -> torch.Tensor:
        if self.assume_pd:
            return _cholesky_or_nan(k_noisy)
        return psd_safe_cholesky(k_noisy)

    @staticmethod
    def force_dense_from_env() -> bool:
        """DKT_GP_FORCE_DENSE: unset, "", 0, false or off (any case) is
        off, anything else on (JAX exact.py:155-164)."""
        return os.environ.get("DKT_GP_FORCE_DENSE", "").strip().lower() not in (
            "", "0", "false", "off")

    def _use_low_rank(self, params: dict, x: torch.Tensor) -> bool:
        """Whether mll and posterior take the Woodbury route at x
        [..., N, D]: the kernel is exactly low-rank, its feature width D'
        is at most N/2, and force_dense is off (JAX exact.py:211-226)."""
        if self.force_dense or self.kernel.low_rank is None:
            return False
        _, z = self.kernel.low_rank(params["kernel"], x[..., :1, :])
        return 2 * z.shape[-1] <= x.shape[-2]

    def init(self, noise: float | None = None, device=None,
             generator=None) -> dict:
        """Parameters on `device`: CUDA when None, raising when there is no
        CUDA device; pass device='cpu' for the CPU. A kernel with random
        parameters (the spectral mixture) draws them from `generator`."""
        device = resolve_device(device)
        return {
            "mean": constant_mean_init(device),
            "kernel": self.kernel.init(device, generator),
            "likelihood": self.likelihood.init(noise, device),
        }

    def mll(self, params: dict, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
        """Exact marginal log likelihood of y [..., N] at x [..., N, D],
        divided by N as gpytorch's ExactMarginalLogLikelihood does."""
        n = x.shape[-2]
        diff = y - constant_mean(params["mean"], x)
        noise = self.likelihood.noise(params["likelihood"])
        if self._use_low_rank(params, x):
            from .low_rank import woodbury_mll

            s, z = self.kernel.low_rank(params["kernel"], x)
            return woodbury_mll(z, diff, s, noise)
        k = self.kernel.apply(params["kernel"], x, x)
        chol = self._factor(_noisy(k, noise))
        alpha = torch.cholesky_solve(diff[..., None], chol)[..., 0]
        quad = torch.sum(diff * alpha, dim=-1)
        logdet = 2.0 * torch.sum(
            torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        return -0.5 * (quad + logdet + n * _LOG_2PI) / n

    def posterior(self, params: dict, x_train: torch.Tensor,
                  y_train: torch.Tensor, x_query: torch.Tensor,
                  full_covariance: bool = False) -> MultivariateNormal:
        """Predictive posterior p(f* | X, y, X*): means and variances
        [..., M] (gpytorch set_train_data + eval-mode forward, reference
        methods/DKT.py:239-240, 258-271). Variances are clamped at 1e-10."""
        kp = params["kernel"]
        diff = y_train - constant_mean(params["mean"], x_train)
        mean_q = constant_mean(params["mean"], x_query)
        noise = self.likelihood.noise(params["likelihood"])
        if self._use_low_rank(params, x_train):
            from .low_rank import woodbury_posterior

            s, z_tr = self.kernel.low_rank(kp, x_train)
            _, z_q = self.kernel.low_rank(kp, x_query)
            mean_adj, var, cov = woodbury_posterior(
                z_tr, diff, z_q, s, noise, full_covariance=full_covariance)
            return MultivariateNormal(mean_q + mean_adj,
                                      torch.clamp(var, min=1e-10), cov)
        k_tt = self.kernel.apply(kp, x_train, x_train)
        k_tq = self.kernel.apply(kp, x_train, x_query)  # [..., N, M]
        chol = self._factor(_noisy(k_tt, noise))
        alpha = torch.cholesky_solve(diff[..., None], chol)  # [..., N, 1]
        mean = mean_q + dot_f32(k_tq.transpose(-1, -2), alpha.transpose(
            -1, -2))[..., 0]
        v = torch.linalg.solve_triangular(chol, k_tq, upper=False)
        if full_covariance:
            cov = self.kernel.apply(kp, x_query, x_query) - dot_f32(
                v.transpose(-1, -2), v.transpose(-1, -2))
            var = torch.diagonal(cov, dim1=-2, dim2=-1)
            return MultivariateNormal(mean, torch.clamp(var, min=1e-10), cov)
        var = self.kernel.diag(kp, x_query) - torch.sum(v * v, dim=-2)
        return MultivariateNormal(mean, torch.clamp(var, min=1e-10), None)


# ---------------------------------------------------------------------------
# Batched one-vs-rest surface (replaces IndependentModelList + SumMLL)
# ---------------------------------------------------------------------------


def sum_mll(gp: ExactGP, params_batched: dict, x: torch.Tensor,
            y_batched: torch.Tensor) -> torch.Tensor:
    """Sum over ways of the per-way MLLs, x [N, D] shared, y [W, N];
    params leaves carry the way axis [W]. One batched [W, N, N] Cholesky
    (reference methods/DKT.py:68-71, 160-163)."""
    return torch.sum(gp.mll(params_batched, x, y_batched))


def batched_posterior(gp: ExactGP, params_batched: dict,
                      x_train: torch.Tensor, y_batched: torch.Tensor,
                      x_query: torch.Tensor) -> MultivariateNormal:
    """Per-way posteriors with shared inputs: [W, M] means and variances."""
    return gp.posterior(params_batched, x_train, y_batched, x_query)


def init_batched(gp: ExactGP, n_way: int, noise: float | None = None,
                 device=None) -> dict:
    """n_way identical parameter sets stacked on a leading axis (every
    reference ExactGPLayer starts from the same softplus(0) constants)."""
    one = gp.init(noise, device)
    return _map(lambda t: t.expand(n_way).clone(), one)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)
