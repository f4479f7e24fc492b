"""Laplace-approximation GP classification: DKT's --laplace test head.

Port of deep_kernel_transfer_tpu/gp/laplace.py, the rebuild of the sklearn
head of reference methods/DKT.py:207-222 (GaussianProcessClassifier with
1.0 * RBF(length_scale=0.1), optimizer=None, one-vs-rest). Binary Laplace
GPC after Rasmussen & Williams, Algorithms 3.1 and 3.2 (logistic link):
Newton iterations on the latent mode with the stable
B = I + W^1/2 K W^1/2, then the probit (MacKay) predictive probability.

Everything is batched: inputs carry leading dimensions (episodes), and the
one-vs-rest head stacks the ways beside them, so every way of every episode
goes through one batched [..., W, N, N] Newton solve of 30 fixed
iterations. All products run in true float32 (no TF32).
"""
from __future__ import annotations

import math

import torch

from .kernels import full_f32, sq_dist


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a [..., N, M] @ v [..., M] -> [..., N]."""
    return (a @ v[..., None])[..., 0]


def _chol(b: torch.Tensor) -> torch.Tensor:
    """Cholesky of B = I + W^1/2 K W^1/2, PD by construction; without the
    error check, which would make the host wait for the card."""
    return torch.linalg.cholesky_ex(b).L


def rbf_gram(x1: torch.Tensor, x2: torch.Tensor, lengthscale: float = 0.1,
             outputscale: float = 1.0) -> torch.Tensor:
    """1.0 * RBF(0.1), the reference's sklearn kernel (DKT.py:212)."""
    return outputscale * torch.exp(-0.5 * sq_dist(x1, x2) / lengthscale ** 2)


def _newton_mode(k: torch.Tensor, t: torch.Tensor,
                 n_iters: int = 30) -> torch.Tensor:
    """The posterior mode f_hat [..., N] for targets t in {0, 1}, K
    [..., N, N] (R&W Algorithm 3.1, a fixed number of iterations; JAX
    laplace.py:38-59)."""
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    f = torch.zeros_like(t)
    for _ in range(n_iters):
        pi = torch.sigmoid(f)
        w = pi * (1.0 - pi)
        sw = torch.sqrt(w)
        chol = _chol(eye + sw[..., :, None] * k * sw[..., None, :])
        b = w * f + (t - pi)
        # a = b - W^1/2 L^-T L^-1 W^1/2 K b
        v = torch.linalg.solve_triangular(chol, (sw * _mv(k, b))[..., None],
                                          upper=False)
        a = b - sw * torch.linalg.solve_triangular(chol.mT, v,
                                                   upper=True)[..., 0]
        f = _mv(k, a)
    return f


def _mode_project(k: torch.Tensor, t: torch.Tensor, k_cols: torch.Tensor,
                  n_iters: int):
    """(f_proj [..., M], v_sq [..., M]): the Newton mode, then the query
    columns k_cols [..., N, M] projected through it and through the B
    factor at the mode (R&W Algorithm 3.2, lines 2-5; JAX
    laplace.py:63-83). The loop's last factor belongs to the iterate
    before f_hat, so the one here is needed."""
    f_hat = _newton_mode(k, t, n_iters)
    pi = torch.sigmoid(f_hat)
    sw = torch.sqrt(pi * (1.0 - pi))
    eye = torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)
    chol = _chol(eye + sw[..., :, None] * k * sw[..., None, :])
    f_proj = _mv(k_cols.mT, t - pi)
    v = torch.linalg.solve_triangular(chol, sw[..., :, None] * k_cols,
                                      upper=False)
    return f_proj, torch.sum(v * v, dim=-2)


@full_f32()
def laplace_predict_proba(x_train: torch.Tensor, t: torch.Tensor,
                          x_query: torch.Tensor, lengthscale: float = 0.1,
                          outputscale: float = 1.0,
                          n_iters: int = 30) -> torch.Tensor:
    """Binary Laplace GPC probabilities [..., M] for targets t in {0, 1}:
    sigmoid(f* / sqrt(1 + pi var / 8)) (JAX laplace.py:86-100)."""
    k = rbf_gram(x_train, x_train, lengthscale, outputscale)
    k_star = rbf_gram(x_train, x_query, lengthscale, outputscale)
    f_star, v_sq = _mode_project(k, t, k_star, n_iters)
    var = torch.clamp(outputscale - v_sq, min=1e-10)
    return torch.sigmoid(f_star / torch.sqrt(1.0 + math.pi * var / 8.0))


@full_f32()
def laplace_ovr_scores(z_support: torch.Tensor, y_support: torch.Tensor,
                       z_query: torch.Tensor, n_way: int,
                       lengthscale: float = 0.1,
                       n_iters: int = 30) -> torch.Tensor:
    """The one-vs-rest ranking scores [..., n_way, M] (JAX
    laplace.py:103-147).

    Ranked on per-query rescaled scores, so that no far query underflows:
    with lengthscale 0.1 on unit-norm features k* = exp(-50 d^2) spans
    1 .. 1e-87, and an f32 sigmoid(f*/den) rounds to 0.5 for every way once
    a query lies d^2 >~ 0.3 from all supports, ranking it as way 0. Here
    k~ = exp(-50 (d^2 - d^2_min)) has a column maximum of 1, and the true
    probability is sigmoid(m f~ / den) with m = exp(-50 d^2_min) > 0 shared
    by all ways of the query, so argmax_w of the probability equals
    argmax_w f~_w / den_w at any distance. m^2 = exp(-d^2_min / l^2) only
    enters the variance, where an underflow to 0 is exact enough."""
    ls2 = lengthscale * lengthscale
    targets = (y_support[None, :] == torch.arange(
        n_way, device=y_support.device)[:, None]).to(z_support.dtype)
    k = rbf_gram(z_support, z_support, lengthscale)  # [..., N, N]
    d2q = sq_dist(z_support, z_query)  # [..., N, M]
    d2min = torch.amin(d2q, dim=-2)  # [..., M]
    k_tilde = torch.exp(-0.5 * (d2q - d2min[..., None, :]) / ls2)
    m2 = torch.exp(-d2min / ls2)
    # the ways beside the leading dimensions: one batched Newton solve
    lead = k.shape[:-2]
    k_w = k[..., None, :, :].expand(lead + (n_way,) + k.shape[-2:])
    kt_w = k_tilde[..., None, :, :].expand(lead + (n_way,) + k_tilde.shape[-2:])
    f_tilde, v_sq_tilde = _mode_project(k_w, targets.expand(
        lead + targets.shape), kt_w, n_iters)
    var = torch.clamp(1.0 - m2[..., None, :] * v_sq_tilde, min=1e-10)
    return f_tilde / torch.sqrt(1.0 + math.pi * var / 8.0)


def laplace_ovr_predict(z_support: torch.Tensor, y_support: torch.Tensor,
                        z_query: torch.Tensor, n_way: int,
                        lengthscale: float = 0.1,
                        n_iters: int = 30) -> torch.Tensor:
    """One-vs-rest prediction: class ids [..., M], the argmax over ways of
    laplace_ovr_scores (sklearn's sequential per-class fit, reference
    methods/DKT.py:213-217, as one batched solve)."""
    return torch.argmax(laplace_ovr_scores(z_support, y_support, z_query,
                                           n_way, lengthscale, n_iters),
                        dim=-2)
