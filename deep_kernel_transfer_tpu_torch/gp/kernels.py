"""Linear-family GP kernels for the ExactGP engine, as pure tensor functions.

Port of deep_kernel_transfer_tpu/gp/kernels.py for the kernel types this
slice runs: `linear`, `cossim` and `bncossim` (reference methods/DKT.py
:351-372). Parameterisation follows GPyTorch: every positive
hyperparameter theta is stored raw with theta = softplus(raw), so a raw
init of 0 gives theta = log 2.

Parameters are nested dicts of tensors. Every leaf may carry leading batch
dimensions (the one-vs-rest way axis): `apply(params, x1, x2)` broadcasts
them against the inputs' batch dimensions and returns [..., N1, N2].
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

# kernel types that reach the rest of the zoo in the JAX package, still to
# port (ROADMAP queue A, item 1)
_NOT_PORTED = ("rbf", "matern", "poli1", "poli2", "spectral")


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def inv_softplus(y) -> torch.Tensor:
    """Inverse of softplus, for initialising raw parameters to a target."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


@contextlib.contextmanager
def full_f32():
    """Keep float32 products out of TF32 on CUDA: a Gram feeds a Cholesky
    (the JAX package pins precision=HIGHEST for the same reason)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def dot_f32(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1 @ x2^T over the last axis, in true float32: [..., N1, N2]."""
    with full_f32():
        return torch.matmul(x1, x2.transpose(-1, -2))


def _lift(p: torch.Tensor) -> torch.Tensor:
    """A batched scalar parameter [...] as [..., 1, 1] against a Gram."""
    return p[..., None, None]


class Kernel(NamedTuple):
    """A pure-functional kernel.

    init(device) -> params; apply(params, x1, x2) -> Gram [..., N1, N2];
    diag(params, x) -> k(x_i, x_i) [..., N]."""

    init: Callable[..., dict]
    apply: Callable[[dict, torch.Tensor, torch.Tensor], torch.Tensor]
    diag: Callable[[dict, torch.Tensor], torch.Tensor]


def linear_kernel(train_variance: bool = True) -> Kernel:
    """k(a, b) = v a.b (gpytorch LinearKernel). cossim/bncossim freeze v at
    1 by leaving it out of the params (reference methods/DKT.py:366-370)."""

    if train_variance:

        def init(device=None):
            return {"raw_variance": torch.zeros((), device=device)}

        def apply(params, x1, x2):
            return _lift(softplus(params["raw_variance"])) * dot_f32(x1, x2)

        def diag(params, x):
            v = softplus(params["raw_variance"])[..., None]
            return v * torch.sum(x * x, dim=-1)

    else:

        def init(device=None):
            return {}

        def apply(params, x1, x2):
            return dot_f32(x1, x2)

        def diag(params, x):
            return torch.sum(x * x, dim=-1)

    return Kernel(init, apply, diag)


def scale(base: Kernel) -> Kernel:
    """gpytorch ScaleKernel: k = outputscale * base(a, b)."""

    def init(device=None):
        return {"raw_outputscale": torch.zeros((), device=device),
                "base": base.init(device)}

    def apply(params, x1, x2):
        s = softplus(params["raw_outputscale"])
        return _lift(s) * base.apply(params["base"], x1, x2)

    def diag(params, x):
        s = softplus(params["raw_outputscale"])[..., None]
        return s * base.diag(params["base"], x)

    return Kernel(init, apply, diag)


def make_kernel(kind: str) -> Kernel:
    """The covariance module for a reference `kernel_type` string
    (reference methods/DKT.py:351-372), linear family only."""
    kind_l = kind.lower()
    if kind_l == "linear":
        return scale(linear_kernel(train_variance=True))
    if kind_l in ("cossim", "bncossim"):
        return scale(linear_kernel(train_variance=False))
    if kind_l in _NOT_PORTED:
        raise NotImplementedError(
            f"kernel '{kind}' is not ported yet (ROADMAP queue A, item 1)")
    raise ValueError(f"[ERROR] the kernel '{kind}' is not supported!")


def normalizes_features(kind: str) -> bool:
    """cossim/bncossim L2-normalise the deep features before the GP
    (reference methods/DKT.py:43-50, 141-142)."""
    return kind.lower() in ("cossim", "bncossim")
