"""The DKT kernel zoo for the ExactGP engine, as pure tensor functions.

Port of deep_kernel_transfer_tpu/gp/kernels.py: the classification
kernel types (reference methods/DKT.py:351-372) `linear`, `cossim`,
`bncossim`, `rbf`, `matern` (nu = 2.5), `poli1` and `poli2`, and the
regression track's ARD spectral mixture `spectral` (reference
methods/DKT_regression.py:117-124) with its optional data-driven init.
Parameterisation follows GPyTorch: every positive
hyperparameter theta is stored raw with theta = softplus(raw), so a raw
init of 0 gives theta = log 2.

Parameters are nested dicts of tensors. Every leaf may carry leading batch
dimensions (the one-vs-rest way axis): `apply(params, x1, x2)` broadcasts
them against the inputs' batch dimensions and returns [..., N1, N2].

The linear family (linear, cossim, bncossim, poli1) is exactly low-rank,
k = s Phi(a).Phi(b), and says so through `low_rank`: the exact GP then
takes the Woodbury route of gp/low_rank.py when 2D <= N (JAX
kernels.py:136-215).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def inv_softplus(y) -> torch.Tensor:
    """Inverse of softplus, for initialising raw parameters to a target."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


@contextlib.contextmanager
def full_f32():
    """Keep float32 products and convolutions out of TF32 on CUDA: a Gram
    feeds a Cholesky (the JAX package pins precision=HIGHEST for the same
    reason)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def dot_f32(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1 @ x2^T over the last axis, in true float32: [..., N1, N2]."""
    with full_f32():
        return torch.matmul(x1, x2.transpose(-1, -2))


def _lift(p: torch.Tensor) -> torch.Tensor:
    """A batched scalar parameter [...] as [..., 1, 1] against a Gram."""
    return p[..., None, None]


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ||a||^2 + ||b||^2 - 2 a.b, [..., N1, N2],
    clamped at 0 (JAX kernels.py:38-47)."""
    x1n = torch.sum(x1 * x1, dim=-1)[..., :, None]
    x2n = torch.sum(x2 * x2, dim=-1)[..., None, :]
    return torch.clamp(x1n + x2n - 2.0 * dot_f32(x1, x2), min=0.0)


def dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise distances with the sqrt clamped at 1e-30, so the gradient
    stays finite on the diagonal (JAX kernels.py:71-75)."""
    return torch.sqrt(torch.clamp(sq_dist(x1, x2), min=1e-30))


def _ones_diag(params, x):
    """k(x, x) = 1 of a stationary kernel, [..., N]."""
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


class Kernel(NamedTuple):
    """A pure-functional kernel.

    init(device, generator) -> params (only the spectral mixture draws
    from `generator`); apply(params, x1, x2) -> Gram [..., N1, N2];
    diag(params, x) -> k(x_i, x_i) [..., N]; low_rank(params, x) -> (s,
    Phi(x) [..., N, D']) with k(a, b) = s Phi(a).Phi(b) exactly, or None
    for a kernel that is not low-rank."""

    init: Callable[..., dict]
    apply: Callable[[dict, torch.Tensor, torch.Tensor], torch.Tensor]
    diag: Callable[[dict, torch.Tensor], torch.Tensor]
    low_rank: Callable[[dict, torch.Tensor], tuple] | None = None


def linear_kernel(train_variance: bool = True) -> Kernel:
    """k(a, b) = v a.b (gpytorch LinearKernel). cossim/bncossim freeze v at
    1 by leaving it out of the params (reference methods/DKT.py:366-370)."""

    if train_variance:

        def init(device=None, generator=None):
            return {"raw_variance": torch.zeros((), device=device)}

        def apply(params, x1, x2):
            return _lift(softplus(params["raw_variance"])) * dot_f32(x1, x2)

        def diag(params, x):
            v = softplus(params["raw_variance"])[..., None]
            return v * torch.sum(x * x, dim=-1)

        def low_rank(params, x):
            return softplus(params["raw_variance"]), x

    else:

        def init(device=None, generator=None):
            return {}

        def apply(params, x1, x2):
            return dot_f32(x1, x2)

        def diag(params, x):
            return torch.sum(x * x, dim=-1)

        def low_rank(params, x):
            return torch.ones((), dtype=x.dtype, device=x.device), x

    return Kernel(init, apply, diag, low_rank)


def rbf_kernel() -> Kernel:
    """k(a, b) = exp(-0.5 ||(a - b) / l||^2), one lengthscale (gpytorch
    RBFKernel; JAX kernels.py:98-110)."""

    def init(device=None, generator=None):
        return {"raw_lengthscale": torch.zeros((), device=device)}

    def apply(params, x1, x2):
        ls = _lift(softplus(params["raw_lengthscale"]))
        return torch.exp(-0.5 * sq_dist(x1 / ls, x2 / ls))

    return Kernel(init, apply, _ones_diag)


def matern_kernel(nu: float = 2.5) -> Kernel:
    """Matern kernel with nu in {0.5, 1.5, 2.5} (gpytorch MaternKernel,
    DKT uses 2.5; JAX kernels.py:113-133)."""
    if nu not in (0.5, 1.5, 2.5):
        raise ValueError(f"unsupported matern nu={nu}")

    def init(device=None, generator=None):
        return {"raw_lengthscale": torch.zeros((), device=device)}

    def apply(params, x1, x2):
        ls = _lift(softplus(params["raw_lengthscale"]))
        d = dist(x1 / ls, x2 / ls)
        if nu == 0.5:
            return torch.exp(-d)
        if nu == 1.5:
            c = math.sqrt(3.0) * d
            return (1.0 + c) * torch.exp(-c)
        c = math.sqrt(5.0) * d
        return (1.0 + c + c * c / 3.0) * torch.exp(-c)

    return Kernel(init, apply, _ones_diag)


def polynomial_kernel(power: int) -> Kernel:
    """k(a, b) = (a.b + c)^power (gpytorch PolynomialKernel, poli1/poli2;
    JAX kernels.py:173-195)."""

    def init(device=None, generator=None):
        return {"raw_offset": torch.zeros((), device=device)}

    def apply(params, x1, x2):
        return (dot_f32(x1, x2) + _lift(softplus(params["raw_offset"]))) ** power

    def diag(params, x):
        offset = softplus(params["raw_offset"])[..., None]
        return (torch.sum(x * x, dim=-1) + offset) ** power

    if power != 1:
        return Kernel(init, apply, diag)

    def low_rank(params, x):
        # (a.b + c) is exactly low-rank: Phi(x) = [x, sqrt(c)]
        col = torch.sqrt(softplus(params["raw_offset"]))[..., None, None] * (
            torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device))
        lead = torch.broadcast_shapes(col.shape[:-2], x.shape[:-2])
        phi = torch.cat([x.expand(lead + x.shape[-2:]),
                         col.expand(lead + col.shape[-2:])], dim=-1)
        return torch.ones((), dtype=x.dtype, device=x.device), phi

    return Kernel(init, apply, diag, low_rank)


def scale(base: Kernel) -> Kernel:
    """gpytorch ScaleKernel: k = outputscale * base(a, b)."""

    def init(device=None, generator=None):
        return {"raw_outputscale": torch.zeros((), device=device),
                "base": base.init(device, generator)}

    def apply(params, x1, x2):
        s = softplus(params["raw_outputscale"])
        return _lift(s) * base.apply(params["base"], x1, x2)

    def diag(params, x):
        s = softplus(params["raw_outputscale"])[..., None]
        return s * base.diag(params["base"], x)

    low_rank = None
    if base.low_rank is not None:
        def low_rank(params, x):
            bs, z = base.low_rank(params["base"], x)
            return softplus(params["raw_outputscale"]) * bs, z

    return Kernel(init, apply, diag, low_rank)


class _Prod(torch.autograd.Function):
    """Product over the last axis whose backward is the product of the
    other factors, from exclusive cumulative products: no division by a
    factor and no host synchronisation (torch.prod's backward searches
    the input for zeros on the host)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.prod(x, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        ones = torch.ones_like(x[..., :1])
        left = torch.cumprod(torch.cat([ones, x[..., :-1]], -1), -1)
        right = torch.cumprod(torch.cat([ones, x[..., 1:].flip(-1)], -1),
                              -1).flip(-1)
        return grad[..., None] * left * right


def spectral_mixture_kernel(num_mixtures: int, ard_num_dims: int) -> Kernel:
    """ARD spectral mixture kernel (Wilson & Adams 2013) in gpytorch's
    product-of-cosines form (JAX kernels.py:218-272):

        k(a, b) = sum_q w_q exp(-2 pi^2 sum_d tau_d^2 s_qd^2)
                        prod_d cos(2 pi tau_d mu_qd),   tau = a - b,

    w, mu, s = softplus of raw_weights [Q], raw_means and raw_scales
    [Q, D]. Both terms are summed over the differences tau [.., N1, N2, D]
    elementwise, as gpytorch does. The JAX package takes the exp term
    through sq_dist of the scaled inputs, |a|^2 + |b|^2 - 2 a.b: over
    Conv3's 2916 features |a|^2 reaches 1e4, and the cancellation leaves
    f32 errors of 1e-3 to 1e-2 in d^2, so exp(-2 pi^2 d^2) loses up to 10%
    on the diagonal, where the true value is exactly 1. gpytorch's raw
    init: weights 0, means and scales N(0, 1) from `generator`.
    k(x, x) = sum_q w_q."""
    q, d = num_mixtures, ard_num_dims

    def init(device=None, generator=None):
        gen_device = device if generator is None else generator.device
        draw = torch.randn((2, q, d), generator=generator, device=gen_device)
        return {"raw_weights": torch.zeros(q, device=device),
                "raw_means": draw[0].to(device),
                "raw_scales": draw[1].to(device)}

    def apply(params, x1, x2):
        w = softplus(params["raw_weights"])
        mu = softplus(params["raw_means"])
        sig = softplus(params["raw_scales"])
        tau = x1[..., :, None, :] - x2[..., None, :, :]  # [.., N1, N2, D]
        out = 0.0
        for i in range(q):
            exp_term = torch.exp(-2.0 * math.pi ** 2 * torch.sum(
                torch.square(tau * sig[i]), dim=-1))
            cos_term = _Prod.apply(torch.cos(2.0 * math.pi * tau * mu[i]))
            out = out + w[i] * exp_term * cos_term
        return out

    def diag(params, x):
        w = softplus(params["raw_weights"])
        return torch.sum(w).expand(x.shape[:-1])

    return Kernel(init, apply, diag)


def spectral_init_from_draws(x: torch.Tensor, y: torch.Tensor,
                             uniform: torch.Tensor,
                             normal: torch.Tensor) -> dict:
    """The data-driven spectral init of initialize_spectral_from_data,
    given its draws U(0, 1) and N(0, 1), each [Q, D]."""
    q = uniform.shape[0]
    xs = torch.sort(x, dim=0).values  # [N, D]
    gaps = torch.diff(xs, dim=0)  # [N-1, D], empty for a one-point task
    if gaps.shape[0] == 0:
        min_dist = torch.ones(xs.shape[1], dtype=xs.dtype, device=xs.device)
    else:
        min_dist = torch.where(gaps > 0, gaps, math.inf).min(dim=0).values
        min_dist = torch.where(torch.isfinite(min_dist), min_dist, 1.0)
    max_dist = torch.clamp(xs[-1] - xs[0], min=1e-6)
    means = uniform * (0.5 / min_dist)[None, :]
    scales = torch.abs(normal) / max_dist[None, :] + 1e-6
    weights = (torch.std(y, correction=0) / q).expand(q) + 1e-6
    return {"raw_weights": inv_softplus(weights),
            "raw_means": inv_softplus(torch.clamp(means, min=1e-6)),
            "raw_scales": inv_softplus(scales)}


def initialize_spectral_from_data(params: dict, x: torch.Tensor,
                                  y: torch.Tensor, generator=None) -> dict:
    """Data-driven spectral-mixture init, gpytorch's initialize_from_data
    heuristic (JAX kernels.py:275-303); optional, the CLIs never call it.
    Mixture weights std(y)/Q; frequency means U(0, 0.5/min_dist) per
    dimension (Nyquist-bounded); inverse scales |N(0, 1)| / max_dist.
    x [N, D], y [N]. Returns new raw params; the draws come from
    `generator` (the JAX package draws from its key)."""
    q, d = params["raw_means"].shape
    gen_device = x.device if generator is None else generator.device
    draw = torch.rand((q, d), generator=generator, device=gen_device)
    normal = torch.randn((q, d), generator=generator, device=gen_device)
    return spectral_init_from_draws(x, y, draw.to(x.device),
                                    normal.to(x.device))


def make_kernel(kind: str, dim: int | None = None,
                num_mixtures: int = 4) -> Kernel:
    """The covariance module for a reference `kernel_type` string
    (reference methods/DKT.py:351-372, methods/DKT_regression.py:117-124;
    JAX kernels.py:311-334). `spectral` needs the feature width `dim`."""
    kind_l = kind.lower()
    if kind_l == "linear":
        return scale(linear_kernel(train_variance=True))
    if kind_l == "rbf":
        return scale(rbf_kernel())
    if kind_l == "matern":
        return scale(matern_kernel(2.5))
    if kind_l == "poli1":
        return scale(polynomial_kernel(1))
    if kind_l == "poli2":
        return scale(polynomial_kernel(2))
    if kind_l in ("cossim", "bncossim"):
        return scale(linear_kernel(train_variance=False))
    if kind_l == "spectral":
        if dim is None:
            raise ValueError(
                "spectral kernel needs the feature dim (ard_num_dims)")
        return spectral_mixture_kernel(num_mixtures, dim)
    raise ValueError(f"[ERROR] the kernel '{kind}' is not supported!")


def normalizes_features(kind: str) -> bool:
    """cossim/bncossim L2-normalise the deep features before the GP
    (reference methods/DKT.py:43-50, 141-142)."""
    return kind.lower() in ("cossim", "bncossim")
