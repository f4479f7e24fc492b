"""Fused one-vs-rest linear-kernel GP MLL: Gram + scale + noise + Cholesky +
explicit inverse + MLL for every (episode, way), in `csrc/fused_mll.cu`.

Port of deep_kernel_transfer_tpu/ops/pallas/fused_mll.py. The forward runs
in `csrc/fused_mll.cu` for CUDA tensors and in `_forward_plain` (torch ops,
the same algorithm) for CPU tensors. Both return the residuals of the
backward: L^-1, alpha and the Gram G. The backward is the closed-form MLL
gradient of the JAX package's `_vjp_bwd` (fused_mll.py:229-253), as torch
ops in f32, with K^-1 = L^-T L^-1 from the forward's L^-1 (no triangular
solve) and G from the forward (no second Gram):

    d mll / dK = 0.5/N (alpha alpha^T - K^-1),   d mll / d diff = -alpha/N

As in the TPU kernel, K is padded with an identity block, here to the next
multiple of 32 (the factor's sub-panel); the residuals are stored at their
real size N.

The scales and diffs are either shared by the batch (scales [W], diffs
[W, N]: meta-training) or each episode's own (scales [B, W], diffs
[B, W, N]: test-time adaptation, the counterpart of vmapping the JAX
function over episodes with batched scales). The kernel reads both forms
through an episode stride, 0 for the shared form, and the backward returns
gradients of the caller's shape.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..gp.kernels import dot_f32, full_f32
from . import build

_LOG_2PI = 1.8378770664093453
MAX_N = 128  # one CTA holds the whole padded matrix in shared memory
SUB_PANEL = 32  # the factor's sub-panel: N is padded to a multiple of it


def supports(kernel_type: str, n: int) -> bool:
    """Whether the fused kernel applies (linear family, one tile)."""
    return kernel_type.lower() in ("cossim", "bncossim", "linear") and n <= MAX_N


def padded_size(n: int) -> int:
    """N rounded up to the factor's sub-panel, as the kernel pads K."""
    return -(-n // SUB_PANEL) * SUB_PANEL


@full_f32()
def _residuals(gram, diffs, scales, diag: float, m: int):
    """(mll [B, W], L^-1 [B, W, N, N], alpha [B, W, N]) of K_w = s_w G +
    diag I padded to m >= N with an identity block, by the kernel's
    algorithm: Cholesky, explicit inverse, y = L^-1 diff, alpha = L^-T y."""
    n = gram.shape[-1]
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    k = scales[..., None, None] * gram[:, None] + diag * eye
    pad = torch.ones(m, dtype=gram.dtype, device=gram.device)
    pad[:n] = 0
    k = F.pad(k, (0, m - n, 0, m - n)) + torch.diag(pad)
    chol = torch.linalg.cholesky(k)
    linv = torch.linalg.solve_triangular(
        chol, torch.eye(m, dtype=k.dtype, device=k.device).expand_as(chol),
        upper=False)
    y = (linv @ F.pad(diffs, (0, m - n))[..., None])[..., 0]
    alpha = (linv.mT @ y[..., None])[..., 0]
    quad = torch.sum(y ** 2, dim=-1)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)[..., :n]), dim=-1)
    mll = -0.5 * (quad + logdet + n * _LOG_2PI) / n
    return mll, linv[..., :n, :n], alpha[..., :n]


def _forward_plain(z, diffs, scales, noise, jitter):
    """(mll [B, W], L^-1 [B, W, N, N], alpha [B, W, N], G [B, N, N]) with
    torch ops."""
    gram = dot_f32(z, z)
    mll, linv, alpha = _residuals(gram, diffs, scales, noise + jitter,
                                  padded_size(z.shape[1]))
    return mll, linv, alpha, gram


def fused_linear_mll_plain(z, diffs, scales, n_real: int, noise: float,
                           jitter: float = 1e-6):
    """The kernel's function in plain differentiable torch ops: [B, W];
    scales and diffs shared ([W], [W, N]) or per episode ([B, W],
    [B, W, N])."""
    _check(z, diffs, scales, n_real)
    return _forward_plain(z, diffs, scales, noise, jitter)[0]


def _check(z, diffs, scales, n_real):
    if z.dim() != 3 or diffs.dim() not in (2, 3) or scales.dim() not in (1, 2):
        raise ValueError(f"want z [B, N, D], diffs [W, N] or [B, W, N], "
                         f"scales [W] or [B, W]; got {tuple(z.shape)}, "
                         f"{tuple(diffs.shape)}, {tuple(scales.shape)}")
    b, n, _ = z.shape
    w = scales.shape[-1]
    if (n != n_real or diffs.shape[-2:] != (w, n)
            or (diffs.dim() == 3 and diffs.shape[0] != b)
            or (scales.dim() == 2 and scales.shape[0] != b)):
        raise ValueError(f"n_real={n_real}, z {tuple(z.shape)}, diffs "
                         f"{tuple(diffs.shape)}, scales {tuple(scales.shape)}")
    if not (z.device == diffs.device == scales.device):
        raise ValueError("z, diffs and scales must be on one device")


def _forward_cuda(z, diffs, scales, noise, jitter):
    for name, t in (("z", z), ("diffs", diffs), ("scales", scales)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_linear_mll kernel takes float32, got "
                            f"{name} {t.dtype}")
    b, n, d = z.shape
    w = scales.shape[-1]
    if n > MAX_N:
        raise ValueError(f"fused_linear_mll kernel takes N <= {MAX_N}, got {n}")
    z, diffs, scales = z.contiguous(), diffs.contiguous(), scales.contiguous()
    out = dict(dtype=torch.float32, device=z.device)
    mll = torch.empty((b, w), **out)
    linv = torch.empty((b, w, n, n), **out)
    alpha = torch.empty((b, w, n), **out)
    gram = torch.empty((b, n, n), **out)
    lib = build.load("fused_mll")
    size = lib.fused_mll_workspace_floats
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    fn = lib.fused_mll_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(z.device):
        work = torch.empty(size(b, n, d), **out)  # the Gram's D-shares
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), diffs.data_ptr(), scales.data_ptr(),
                 mll.data_ptr(), linv.data_ptr(), alpha.data_ptr(),
                 gram.data_ptr(), work.data_ptr(), b, n, d, w,
                 int(scales.dim() == 2), int(diffs.dim() == 3),
                 float(noise + jitter), stream)
    if err != 0:
        raise RuntimeError(f"fused_mll_forward launch failed: "
                           f"{build.error_name(err)}")
    fused_linear_mll.launches += 1
    return mll, linv, alpha, gram


class _FusedLinearMLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, diffs, scales, noise, jitter):
        fwd = _forward_cuda if z.is_cuda else _forward_plain
        mll, linv, alpha, gram = fwd(z, diffs, scales, noise, jitter)
        ctx.save_for_backward(z, scales, linv, alpha, gram)
        ctx.diffs_per_episode = diffs.dim() == 3
        return mll

    @staticmethod
    @full_f32()
    def backward(ctx, g):
        z, scales, linv, alpha, gram = ctx.saved_tensors
        n = z.shape[1]
        kinv = linv.mT @ linv  # K^-1 = L^-T L^-1
        dk = (0.5 / n) * (alpha[..., :, None] * alpha[..., None, :] - kinv)
        dk = dk * g[:, :, None, None]
        # K_w = s_w Z Z^T + noise I; a shared parameter's gradient is the
        # sum over episodes, a per-episode one keeps the episode axis
        per_ep = "bw" if scales.dim() == 2 else "w"
        dz = None
        if ctx.needs_input_grad[0]:
            m = torch.einsum(f"bwij,{per_ep}->bij", dk + dk.mT, scales)
            dz = m @ z
        dscales = torch.einsum(f"bwij,bij->{per_ep}", dk, gram)
        out = "bwi" if ctx.diffs_per_episode else "wi"
        ddiffs = -torch.einsum(f"bw,bwi->{out}", g, alpha) / n
        return dz, ddiffs, dscales, None, None


def fused_linear_mll(z, diffs, scales, n_real: int, noise: float,
                     jitter: float = 1e-6):
    """Batched one-vs-rest linear-kernel MLLs: [B, W].

    z [B, N, D] features, diffs [W, N] = targets - mean, scales [W]
    positive outputscales, both shared by the batch; or diffs [B, W, N] and
    scales [B, W], each episode's own. K_w = s_w Z Z^T + (noise + jitter) I.
    Matches
    ExactGP.mll (with gpytorch's 1/N scaling) for the scale(linear) kernel
    family. CUDA tensors launch the kernel (float32 only, N <= 128); CPU
    tensors take the plain torch version."""
    _check(z, diffs, scales, n_real)
    return _FusedLinearMLL.apply(z, diffs, scales, float(noise), float(jitter))


fused_linear_mll.launches = 0  # kernel launches; the plain path never counts
