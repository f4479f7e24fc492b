"""Batched lower Cholesky, right-looking over 128-tiles, for N in
{128, 256, 384, 512}.

Port of deep_kernel_transfer_tpu/ops/pallas/blocked_cholesky.py. The
forward runs in `csrc/blocked_cholesky.cu` for CUDA tensors and in
`blocked_cholesky_plain` (the same tile algorithm in torch ops) for CPU
tensors; the backward is Murray's Cholesky reverse mode (`chol_rev`, the
JAX package's `_bwd`, blocked_cholesky.py:178-193) in f32 torch ops.

As in the JAX package, an N that is not a multiple of 128, or is above 512,
goes to the stock Cholesky, decided by shape before any launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..gp.kernels import full_f32
from . import build

T = 128  # tile edge
MAX_N = 512


def uses_kernel(n: int) -> bool:
    """Whether an [.., N, N] matrix takes the tile kernel (else the stock
    Cholesky), as blocked_cholesky.py:152 decides."""
    return n % T == 0 and n <= MAX_N


@full_f32()
def chol_rev(chol: torch.Tensor, chol_bar: torch.Tensor) -> torch.Tensor:
    """Cholesky reverse mode (Murray 2016): K_bar = 0.5 L^-T (P + P^T) L^-1
    with P = Phi(L^T L_bar), Phi the lower triangle with halved diagonal."""
    p = chol.mT @ chol_bar
    p = torch.tril(p) - 0.5 * torch.diag_embed(
        torch.diagonal(p, dim1=-2, dim2=-1))
    s = p + p.mT
    tmp = torch.linalg.solve_triangular(chol.mT, s, upper=True)  # L^-T S
    x = torch.linalg.solve_triangular(chol.mT, tmp.mT, upper=True).mT
    return 0.5 * x


def tile_inverse(lkk: torch.Tensor) -> torch.Tensor:
    """L_kk^-1 of lower-triangular tiles [..., T, T], lower-triangular."""
    eye = torch.eye(lkk.shape[-1], dtype=lkk.dtype, device=lkk.device)
    return torch.linalg.solve_triangular(lkk, eye, upper=False)


@full_f32()
def blocked_cholesky_plain(kmat: torch.Tensor,
                           product=torch.matmul) -> torch.Tensor:
    """The kernel's function in torch ops, by the kernel's algorithm:
    for each 128-tile k, factor the diagonal tile and invert it, form the
    panel below it as A_ik L_kk^-T and update the trailing matrix; the
    upper triangle is zero. `product` forms the panel and the update
    (`ops.tf32x3.tf32x3_matmul` repeats the kernel's 3xTF32 arithmetic).
    Other N take the stock Cholesky."""
    n = kmat.shape[-1]
    if not uses_kernel(n):
        return torch.linalg.cholesky(kmat)
    a = kmat.clone()
    for k in range(n // T):
        lo, hi = k * T, (k + 1) * T
        lkk = torch.linalg.cholesky(a[:, lo:hi, lo:hi])
        a[:, lo:hi, lo:hi] = lkk
        if hi < n:
            panel = product(a[:, hi:, lo:hi], tile_inverse(lkk).mT)
            a[:, hi:, lo:hi] = panel
            a[:, hi:, hi:] = a[:, hi:, hi:] - product(panel, panel.mT)
    return torch.tril(a)


def _forward_cuda(kmat: torch.Tensor) -> torch.Tensor:
    if kmat.dtype != torch.float32:
        raise TypeError(f"blocked_cholesky kernel takes float32, got "
                        f"{kmat.dtype}")
    kmat = kmat.contiguous()
    b, n, _ = kmat.shape
    chol = torch.empty_like(kmat)
    if b == 0:
        return chol
    linv = kmat.new_empty((b, T, T))  # the factor kernel's tile inverses
    fn = build.load("blocked_cholesky").blocked_cholesky_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(kmat.device):
        err = fn(kmat.data_ptr(), chol.data_ptr(), linv.data_ptr(), b, n,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"blocked_cholesky_forward launch failed: "
                           f"{build.error_name(err)}")
    blocked_cholesky.launches += 1
    return chol


class _BlockedCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kmat):
        chol = _forward_cuda(kmat) if kmat.is_cuda else blocked_cholesky_plain(
            kmat)
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, chol_bar):
        chol, = ctx.saved_tensors
        return chol_rev(chol, chol_bar)


def blocked_cholesky(kmat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of a batched SPD matrix [B, N, N]. N a multiple of 128
    and at most 512 takes the tile kernel on CUDA tensors (float32) and its
    plain version on CPU tensors; any other N takes torch.linalg.cholesky
    and counts no launch."""
    if kmat.dim() != 3 or kmat.shape[-1] != kmat.shape[-2]:
        raise ValueError(f"want K [B, N, N], got {tuple(kmat.shape)}")
    if not uses_kernel(kmat.shape[-1]):
        return torch.linalg.cholesky(kmat)
    return _BlockedCholesky.apply(kmat)


blocked_cholesky.launches = 0  # kernel launches; the plain path never counts
