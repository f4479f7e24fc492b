"""Woodbury / matrix-determinant-lemma GP route for the low-rank kernels.

Port of deep_kernel_transfer_tpu/gp/low_rank.py. For the linear family
(linear, cossim, bncossim, poli1) the Gram is exactly K = s Z Z^T with
Z = Phi(X) [N, D], so for N > D the N x N Cholesky is the wrong algorithm.
With noise sigma^2 and the [D, D] capacitance M = s^-1 I + sigma^-2 Z^T Z:

  (sigma^2 I + s Z Z^T)^-1 = sigma^-2 (I - Z M^-1 Z^T sigma^-2)
  logdet(sigma^2 I + s Z Z^T) = N log sigma^2 + D log s + logdet M

so the MLL and the posterior cost O(N D^2 + D^3), with no N x N object.
gp/exact.py routes here when the kernel has `low_rank` and 2D <= N.

Every product runs in true float32 (no TF32): the quad form is a
near-cancelling difference, and one rounded operand breaks its agreement
with the dense route. The JAX package pads M with an identity block to
dodge a TPU compiler fault (low_rank.py:43-56); the pad is exact, so the
port leaves it out. Batch dimensions broadcast: z [..., N, D], diff
[..., N], s and noise scalars or [...].
"""
from __future__ import annotations

import torch

from .exact import _LOG_2PI, psd_safe_cholesky
from .kernels import full_f32


def _m_chol(z: torch.Tensor, s, noise) -> torch.Tensor:
    """Cholesky of M = s^-1 I + noise^-1 Z^T Z, [..., D, D]."""
    d = z.shape[-1]
    eye = torch.eye(d, dtype=z.dtype, device=z.device)
    m = (z.mT @ z) / noise + eye / s[..., None, None]
    return psd_safe_cholesky(m)


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


@full_f32()
def woodbury_mll(z: torch.Tensor, diff: torch.Tensor, s, noise) -> torch.Tensor:
    """Exact MLL of diff ~ N(0, s Z Z^T + noise I) with gpytorch's 1/N
    scaling (ExactGP.mll for a low-rank kernel): [...]."""
    n, d = z.shape[-2:]
    s, noise = _as_tensor(s, z), _as_tensor(noise, z)
    t = (z.mT @ diff[..., None])[..., 0]  # [..., D]
    lc = _m_chol(z, s, noise)
    m_inv_t = torch.cholesky_solve(t[..., None], lc)[..., 0]
    quad = (torch.sum(diff * diff, dim=-1)
            - torch.sum(t * m_inv_t, dim=-1) / noise) / noise
    logdet = (n * torch.log(noise) + d * torch.log(s) + 2.0 * torch.sum(
        torch.log(torch.diagonal(lc, dim1=-2, dim2=-1)), dim=-1))
    return -0.5 * (quad + logdet + n * _LOG_2PI) / n


@full_f32()
def woodbury_posterior(z_train: torch.Tensor, diff: torch.Tensor,
                       z_query: torch.Tensor, s, noise,
                       full_covariance: bool = False):
    """(mean adjustment [..., M], variance [..., M], covariance [..., M, M]
    or None) of the noise-free f* at the query features, conditioned on
    (Z, diff), in the weight-space form (Rasmussen & Williams eq. 2.11):

        mean* = Zq M^-1 Z^T diff / noise,   cov* = Zq M^-1 Zq^T

    which has no large-term cancellation and is PSD by construction."""
    s, noise = _as_tensor(s, z_train), _as_tensor(noise, z_train)
    t = (z_train.mT @ diff[..., None])[..., 0]
    lc = _m_chol(z_train, s, noise)
    w = torch.cholesky_solve(t[..., None], lc)  # [..., D, 1]
    mean_adj = (z_query @ w)[..., 0] / noise
    # U = Lc^-1 Zq^T, so Zq M^-1 Zq^T = U^T U
    lead = torch.broadcast_shapes(lc.shape[:-2], z_query.shape[:-2])
    u = torch.linalg.solve_triangular(
        lc.expand(lead + lc.shape[-2:]),
        z_query.mT.expand(lead + z_query.mT.shape[-2:]), upper=False)
    var = torch.sum(u * u, dim=-2)
    cov = u.mT @ u if full_covariance else None
    return mean_adj, var, cov
