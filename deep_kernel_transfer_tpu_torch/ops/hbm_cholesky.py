"""Left-looking tile-blocked Cholesky for large N, and its fused-Gram form.

Port of deep_kernel_transfer_tpu/ops/pallas/hbm_cholesky.py. One CUDA
source, `csrc/hbm_cholesky.cu`, serves three entry points:

  hbm_blocked_cholesky(K, diag)          chol(K + diag I), [B, N, N]
  fused_gram_cholesky(Z, scale, diag)    chol(scale Z Z^T + diag I), no
                                         N x N Gram is ever stored
  fused_gram_cholesky_tiled(Z, s, diag)  the same factor tile-blocked,
                                         [B, nt, nt, 128, 128], forward only

CUDA tensors launch the kernel; CPU tensors take the plain versions, which
run the kernel's left-looking algorithm in torch ops. The backwards are the
JAX package's, in f32 torch ops: Murray's reverse mode (`chol_rev`), and
for the fused form the Gram-free contractions of `_fused_bwd`
(hbm_cholesky.py:376-387). `tiled_log_det` and `tile_matrix` are torch ops.

N (and D) must be multiples of 128; other shapes raise ValueError.
"""
from __future__ import annotations

import ctypes

import torch

from ..gp.kernels import full_f32
from . import build
from .blocked_cholesky import chol_rev, tile_inverse

T = 128  # tile edge


def tile_matrix(kmat: torch.Tensor) -> torch.Tensor:
    """[B, N, N] -> tile-blocked [B, nt, nt, T, T] (a contiguous copy)."""
    b, n, _ = kmat.shape
    nt = n // T
    return kmat.reshape(b, nt, T, nt, T).permute(0, 1, 3, 2, 4).contiguous()


def untile_matrix(lt: torch.Tensor) -> torch.Tensor:
    """Tile-blocked [B, nt, nt, T, T] -> [B, N, N] (a contiguous copy)."""
    b, nt = lt.shape[:2]
    return lt.permute(0, 1, 3, 2, 4).reshape(b, nt * T, nt * T)


def tiled_log_det(lt: torch.Tensor) -> torch.Tensor:
    """logdet = 2 sum log diag(L) from a tile-blocked factor [B, nt, nt, T,
    T]: [B]. Reads the diagonal tiles through views, allocating no N x N."""
    d = lt.diagonal(dim1=1, dim2=2).diagonal(dim1=1, dim2=2)  # [B, nt, T]
    return 2.0 * torch.log(d).sum(dim=(-1, -2))


def _check(name: str, x: torch.Tensor, fused: bool) -> None:
    if x.dim() != 3 or (not fused and x.shape[-1] != x.shape[-2]):
        want = "Z [B, N, D]" if fused else "K [B, N, N]"
        raise ValueError(f"{name}: want {want}, got {tuple(x.shape)}")
    if x.shape[1] % T != 0:
        raise ValueError(f"{name}: N={x.shape[1]} must be a multiple of {T}")
    if fused and x.shape[2] % T != 0:
        raise ValueError(f"{name}: D={x.shape[2]} must be a multiple of {T} "
                         "(pad the features)")


def _value(x) -> float:
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


# ---------------------------------------------------------------- plain


@full_f32()
def _tiled_plain(src: torch.Tensor, fused: bool, scale: float,
                 diag: float, product=torch.matmul) -> torch.Tensor:
    """The kernel's left-looking algorithm in torch ops, tile-blocked; the
    tiles above the diagonal are zero. Column k: C_ik = G(i, k) - sum_{j<k}
    L_ij L_kj^T for i >= k, L_kk = chol(C_kk), L_ik = C_ik L_kk^-T through
    the explicit inverse. `product` forms the Gram, strip and panel
    products (`ops.tf32x3.tf32x3_matmul` repeats the kernel's 3xTF32
    arithmetic)."""
    b, n = src.shape[:2]
    nt = n // T
    out = src.new_zeros((b, nt, nt, T, T))
    eye = torch.eye(T, dtype=src.dtype, device=src.device)
    for k in range(nt):
        lo, hi = k * T, (k + 1) * T
        if fused:
            col = scale * product(src[:, lo:], src[:, lo:hi].mT)
        else:
            col = src[:, lo:, lo:hi]
        col = col.reshape(b, nt - k, T, T)
        if k:
            # the strip of tile row i, [T, k T], against that of row k
            rows = out[:, k:, :k].transpose(2, 3).reshape(b, nt - k, T, k * T)
            strip = out[:, k, :k].transpose(1, 2).reshape(b, 1, T, k * T)
            col = col - product(rows, strip.mT)
        lkk = torch.linalg.cholesky(col[:, 0] + diag * eye)
        out[:, k, k] = lkk
        if k + 1 < nt:
            out[:, k + 1:, k] = product(col[:, 1:],
                                        tile_inverse(lkk).mT[:, None])
    return out


def hbm_blocked_cholesky_plain(kmat, diag=0.0) -> torch.Tensor:
    """chol(K + diag I) by the kernel's algorithm in torch ops."""
    _check("hbm_blocked_cholesky", kmat, fused=False)
    return untile_matrix(_tiled_plain(kmat, False, 1.0, _value(diag)))


def fused_gram_cholesky_plain(z, scale, diag) -> torch.Tensor:
    """chol(scale Z Z^T + diag I) by the kernel's algorithm in torch ops."""
    _check("fused_gram_cholesky", z, fused=True)
    return untile_matrix(_tiled_plain(z, True, _value(scale), _value(diag)))


def fused_gram_cholesky_tiled_plain(z, scale, diag) -> torch.Tensor:
    """The tile-blocked factor by the kernel's algorithm in torch ops."""
    _check("fused_gram_cholesky_tiled", z, fused=True)
    return _tiled_plain(z, True, _value(scale), _value(diag))


# --------------------------------------------------------------- kernel


def _tiled_cuda(src: torch.Tensor, fused: bool, scale: float,
                diag: float) -> torch.Tensor:
    """Launch the kernel: the tile-blocked factor [B, nt, nt, T, T], tiles
    above the diagonal left unwritten (torch.empty)."""
    if src.dtype != torch.float32:
        raise TypeError(f"hbm_cholesky kernel takes float32, got {src.dtype}")
    src = src.contiguous()
    b, n, d = src.shape
    nt = n // T
    out = torch.empty((b, nt, nt, T, T), dtype=torch.float32,
                      device=src.device)
    if b == 0:
        return out
    linv = src.new_empty((b, T, T))  # the factor kernel's tile inverses
    fn = build.load("hbm_cholesky").hbm_cholesky_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), out.data_ptr(), linv.data_ptr(), b, n, d,
                 int(fused), scale, diag,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hbm_cholesky_forward launch failed: "
                           f"{build.error_name(err)}")
    return out


def _untiled_cuda(src, fused, scale, diag) -> torch.Tensor:
    return untile_matrix(_tiled_cuda(src, fused, scale, diag)).tril_()


def _trace_sum(kbar: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(kbar, dim1=-2, dim2=-1).sum()


class _HbmCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kmat, diag):
        d = _value(diag)
        if kmat.is_cuda:
            chol = _untiled_cuda(kmat, False, 1.0, d)
            hbm_blocked_cholesky.launches += 1
        else:
            chol = hbm_blocked_cholesky_plain(kmat, d)
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, chol_bar):
        chol, = ctx.saved_tensors
        kbar = chol_rev(chol, chol_bar)
        dbar = _trace_sum(kbar) if ctx.needs_input_grad[1] else None
        return kbar, dbar


class _FusedGramCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, scale, diag):
        s, d = _value(scale), _value(diag)
        if z.is_cuda:
            chol = _untiled_cuda(z, True, s, d)
            fused_gram_cholesky.launches += 1
        else:
            chol = fused_gram_cholesky_plain(z, s, d)
        ctx.save_for_backward(z, chol)
        ctx.scale = s
        return chol

    @staticmethod
    @full_f32()
    def backward(ctx, chol_bar):
        z, chol = ctx.saved_tensors
        kbar = chol_rev(chol, chol_bar)
        # Gram-free: sum(kbar * Z Z^T) == sum((kbar Z) * Z), so no N x N
        # Gram is built here either
        kz = kbar @ z
        zbar = ctx.scale * (kz + kbar.mT @ z)
        sbar = (kz * z).sum() if ctx.needs_input_grad[1] else None
        dbar = _trace_sum(kbar) if ctx.needs_input_grad[2] else None
        return zbar, sbar, dbar


def hbm_blocked_cholesky(kmat: torch.Tensor, diag=0.0) -> torch.Tensor:
    """Lower Cholesky of K + diag I, K [B, N, N] f32, N a multiple of 128;
    diag a float or a 0-d tensor (differentiable). CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    _check("hbm_blocked_cholesky", kmat, fused=False)
    return _HbmCholesky.apply(kmat, diag)


def fused_gram_cholesky(z: torch.Tensor, scale, diag) -> torch.Tensor:
    """chol(scale Z Z^T + diag I) for Z [B, N, D] f32, N and D multiples of
    128, without storing the N x N Gram; scale and diag floats or 0-d
    tensors (differentiable). The linear/cossim/bncossim kernel family.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    _check("fused_gram_cholesky", z, fused=True)
    return _FusedGramCholesky.apply(z, scale, diag)


def fused_gram_cholesky_tiled(z: torch.Tensor, scale, diag) -> torch.Tensor:
    """chol(scale Z Z^T + diag I) tile-blocked, [B, nt, nt, T, T], tiles
    above the diagonal undefined: the memory-bound regime's entry point,
    whose only N x N object is the factor itself. Forward only: raises if
    an input requires grad. Read it with `tiled_log_det`."""
    _check("fused_gram_cholesky_tiled", z, fused=True)
    if any(isinstance(x, torch.Tensor) and x.requires_grad
           for x in (z, scale, diag)):
        raise ValueError("fused_gram_cholesky_tiled is forward only; use "
                         "fused_gram_cholesky for gradients")
    s, d = _value(scale), _value(diag)
    if not z.is_cuda:
        return _tiled_plain(z, True, s, d)
    out = _tiled_cuda(z, True, s, d)
    fused_gram_cholesky_tiled.launches += 1
    return out


# kernel launches of each entry point; the plain path never counts
hbm_blocked_cholesky.launches = 0
fused_gram_cholesky.launches = 0
fused_gram_cholesky_tiled.launches = 0
