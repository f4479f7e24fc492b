"""Episodic BatchNorm (+ReLU) for bf16 4-D activations, in training mode
(`episodic_batchnorm`) and in eval mode (`episodic_batchnorm_eval`):
`csrc/episodic_batchnorm.cu` on the card, the same algorithm in torch ops
(`_forward_plain`, `_backward_plain`, `_eval_plain`) on the CPU.
`batchnorm` chooses among these kernels and `batchnorm_torch`, the
BatchNorm of any dtype and rank in torch ops, for every
models/backbones.py::EpisodicBatchNorm.

Replaces no Pallas kernel: the JAX package leaves its BatchNorm
(deep_kernel_transfer_tpu/models/backbones.py:120-139) to XLA's fusion.
x [G n, C, H, W] is G episodes of n images; each episode's statistics are
its own. In channels-last memory an episode is a dense [P, C] block, P = n
H W, which the kernels stream with 16-byte accesses along C:

  forward   mean, var = sum x / P, max(sum x^2 / P - mean^2, 0)  (f32)
            scale = bf16(w) rsqrt(var + eps), shift = bf16(b) - mean scale
            y = bf16(x scale + shift), then max(y, 0) with `relu`
  backward  dy' = dy [y > 0] (with `relu`), xh = (x - mean) rsqrt(var + eps)
            dx = scale (dy' - sum dy' / P - xh sum dy' xh / P)
            dw, db = bf16(sum over episodes of sum dy' xh, sum dy')

The variance is the one-pass law of the JAX package and of the port's bf16
torch path; its derivative is the two-pass one's. Sums are f32 partials of
the row splits that `plan` gives, added in a fixed order. Autograd saves the
bf16 x and the [5, G, C] statistics (mean, var, rstd, scale, shift); the
ReLU mask is recomputed from them by the forward's arithmetic. Under
create_graph the backward runs `_backward_plain` with grad mode on, which
recomputes the statistics from x, so higher derivatives follow.

In eval mode the running mean and var stand in for the batch's, over the
whole batch: scale and shift come from them by the same law, and one
apply pass over the [n H W, C] block writes y, 4 bytes an element. It
records no gradient, so it is taken only where none is wanted. An eval
ConvBlock (models/backbones.py) on the card goes further where
`takes_eval_epilogue` says so: its convolution runs without its bias b_c,
and one pass adds it (bf16(x + bf16(b_c)), rounded as ATen's bias pass
after cuDNN rounds it), applies the BatchNorm and the ReLU, and where the
block pools, writes only the 2x2 max-pooled map: 2.5 bytes an element in
place of the 10.5 that the bias add, the apply and torch's max-pool moved
as three passes, and the same output bit for bit.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

VEC = 8  # bf16 channels in one 16-byte access
THREADS = 256  # a streaming CTA's threads, at most
MAX_C = VEC * THREADS
# The row splits of an episode: enough CTAs for a few waves on the card's
# 132 SMs, none with fewer than MIN_ELEMENTS elements, at most MAX_SPLITS.
TARGET_CTAS = 2048
MIN_ELEMENTS = 16384
MAX_SPLITS = 512
# The eval passes' row split: about EVAL_ELEMENTS input elements a CTA, so
# that a large map spreads over many waves of short CTAs and the last
# wave's tail is short; at most MAX_GRID CTAs (the kernels' launch limit).
EVAL_ELEMENTS = 32768
MAX_GRID = 65535


def _takes(dtype: torch.dtype, c: int) -> bool:
    """bf16, C a multiple of 8 up to 2048."""
    return dtype == torch.bfloat16 and c % VEC == 0 and VEC <= c <= MAX_C


def supports(x: torch.Tensor) -> bool:
    """Whether the kernels take x: bf16, 4-D, C a multiple of 8 up to
    2048."""
    return x.dim() == 4 and x.numel() > 0 and _takes(x.dtype, x.shape[1])


def takes_eval_epilogue(x: torch.Tensor, channels: int, train: bool,
                        *params: torch.Tensor | None) -> bool:
    """Whether an eval ConvBlock of x takes the fused epilogue: its
    convolution to `channels` channels runs without its bias, and
    `episodic_batchnorm_eval` adds that bias, normalises and pools where
    the block pools, in one pass. Taken in eval mode, on a CUDA device,
    where the conv output is one that `supports` takes (a non-empty 4-D
    bf16 x, `channels` a multiple of 8 up to 2048) and no gradient is
    recorded on x or `params` (the conv's and the BatchNorm's). Every
    other block keeps the chain of conv with bias, `batchnorm` and
    max_pool2d."""
    return (not train and x.is_cuda and x.dim() == 4 and x.numel() > 0
            and _takes(x.dtype, channels) and not records_grad(x, *params))


def plan(groups: int, rows: int, c: int) -> tuple[int, int]:
    """(splits, rows a split) of an episode's `rows` rows of c channels:
    rows a split a multiple of the CTA's rows at once (256 / (c / 8))."""
    tile_rows = THREADS // (c // VEC)
    splits = max(1, min(-(-rows * c // MIN_ELEMENTS),
                        -(-TARGET_CTAS // groups), MAX_SPLITS))
    per_split = -(-rows // splits)
    per_split = -(-per_split // tile_rows) * tile_rows
    return -(-rows // per_split), per_split


def eval_plan(rows: int, c: int, window: int = 1) -> tuple[int, int]:
    """(splits, rows a split) of an eval pass over `rows` output rows of c
    channels, each read from `window` input rows (4 where it pools): rows
    a split a multiple of the CTA's rows at once."""
    tile_rows = THREADS // (c // VEC)
    splits = max(1, min(-(-rows * c * window // EVAL_ELEMENTS), MAX_GRID))
    per_split = -(-rows // splits)
    per_split = -(-per_split // tile_rows) * tile_rows
    return -(-rows // per_split), per_split


def records_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether an op on these tensors (None for an absent one) would record
    a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[G n, C, H, W] -> [G, n H W, C] (a view of channels-last memory)."""
    return t.permute(0, 2, 3, 1).reshape(groups, -1, t.shape[1])


def _ungrouped(v: torch.Tensor, shape) -> torch.Tensor:
    """[G, n H W, C] -> [G n, C, H, W] in channels-last memory."""
    n, c, h, w = shape
    return v.reshape(n, h, w, c).permute(0, 3, 1, 2)


def _split_sums(v: torch.Tensor) -> torch.Tensor:
    """[G, P, C] -> [G, C]: f32 sums of the kernels' row splits, added in
    split order."""
    groups, rows, c = v.shape
    splits, per_split = plan(groups, rows, c)
    v = F.pad(v, (0, 0, 0, splits * per_split - rows))
    return v.reshape(groups, splits, per_split, c).sum(2).sum(1)


def statistics(xg: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """[5, G, C] = mean, var, rstd, scale, shift of f32 xg [G, P, C]."""
    rows = xg.shape[1]
    mean = _split_sums(xg) / rows
    var = torch.clamp(_split_sums(xg * xg) / rows - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    scale = weight.to(torch.bfloat16).float() * rstd
    shift = bias.to(torch.bfloat16).float() - mean * scale
    return torch.stack([mean, var, rstd, scale, shift])


def _affine(xg, stats):
    """The forward's output before the ReLU, f32 [G, P, C]."""
    return xg * stats[3][:, None] + stats[4][:, None]


def _forward_plain(x, weight, bias, groups: int, eps: float, relu: bool):
    """(y, stats) with torch ops."""
    xg = _grouped(x, groups).float()
    stats = statistics(xg, weight, bias, eps)
    y = _affine(xg, stats)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return _ungrouped(y.to(torch.bfloat16), x.shape), stats


def _backward_plain(dy, x, weight, bias, stats, groups: int, eps: float,
                    relu: bool):
    """(dx, dw, db) with torch ops; stats None recomputes them from x (the
    differentiable form under create_graph)."""
    xg = _grouped(x, groups).float()
    rows = xg.shape[1]
    if stats is None:
        stats = statistics(xg, weight, bias, eps)
    d = _grouped(dy, groups).float()
    if relu:
        d = d * (_affine(xg, stats).to(torch.bfloat16) > 0)
    mean, rstd, scale = stats[0][:, None], stats[2][:, None], stats[3][:, None]
    xh = (xg - mean) * rstd
    sdy, sdyx = _split_sums(d), _split_sums(d * xh)
    dx = scale * (d - sdy[:, None] / rows - xh * sdyx[:, None] / rows)
    return (_ungrouped(dx.to(torch.bfloat16), x.shape),
            _param_grad(sdyx, weight), _param_grad(sdy, bias))


def _param_grad(per_episode: torch.Tensor, param: torch.Tensor):
    """The sum over episodes, rounded through bf16 as autograd's casts of
    the weight (f32 -> bf16 -> f32) round it."""
    return per_episode.sum(0).to(torch.bfloat16).to(param.dtype)


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    """t itself where its memory is channels-last and 16-byte aligned, else
    a channels-last copy (counted)."""
    if (t.is_contiguous(memory_format=torch.channels_last)
            and t.data_ptr() % 16 == 0):
        return t
    episodic_batchnorm.copies += 1
    return t.contiguous(memory_format=torch.channels_last)


def _ctypes(fn, n_ptr: int, ints: list):
    fn.argtypes = [ctypes.c_void_p] * n_ptr + ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _shape(x, groups):
    n, c, h, w = x.shape
    rows = n // groups * h * w
    return c, rows, plan(groups, rows, c)


def _forward_cuda(x, weight, bias, groups: int, eps: float, relu: bool):
    c, rows, (splits, per_split) = _shape(x, groups)
    f32 = dict(dtype=torch.float32, device=x.device)
    weight = weight.detach().to(torch.float32).contiguous()
    bias = bias.detach().to(torch.float32).contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((groups, splits, 2, c), **f32)
    stats = torch.empty((5, groups, c), **f32)
    fn = _ctypes(build.load("episodic_batchnorm").episodic_bn_forward, 6,
                 [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_float, ctypes.c_int])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), part.data_ptr(), stats.data_ptr(), groups,
                 rows, c, splits, per_split, float(eps), int(relu),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"episodic_bn_forward launch failed: "
                           f"{build.error_name(err)}")
    episodic_batchnorm.launches += 1
    return y, stats


def _backward_cuda(dy, x, stats, groups: int, relu: bool):
    c, rows, (splits, per_split) = _shape(x, groups)
    dy = _channels_last(dy)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty((groups, splits, 2, c), **f32)
    sums = torch.empty((2, groups, c), **f32)
    fn = _ctypes(build.load("episodic_batchnorm").episodic_bn_backward, 6,
                 [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_int])
    with torch.cuda.device(x.device):
        err = fn(dy.data_ptr(), x.data_ptr(), dx.data_ptr(), stats.data_ptr(),
                 part.data_ptr(), sums.data_ptr(), groups, rows, c, splits,
                 per_split, int(relu), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"episodic_bn_backward launch failed: "
                           f"{build.error_name(err)}")
    episodic_batchnorm.launches += 1
    return dx, sums


def _eval_coeffs(weight, bias, running_mean, running_var, eps: float):
    """The eval finalize's f32 scale and shift [C]: scale = bf16(w)
    rsqrt(var + eps), shift = bf16(b) - mean scale."""
    scale = (weight.to(torch.bfloat16).float()
             * torch.rsqrt(running_var.float() + eps))
    shift = bias.to(torch.bfloat16).float() - running_mean.float() * scale
    return scale, shift


def _biased(x, conv_bias):
    """f32 bf16(x + bf16(conv_bias)): a convolution's bias added as ATen
    adds it after cuDNN (an f32 sum rounded to bf16); x itself without
    one."""
    if conv_bias is None:
        return x.float()
    b = conv_bias.to(torch.bfloat16).float().view(1, -1, 1, 1)
    return (x.float() + b).to(torch.bfloat16).float()


def _eval_plain(x, weight, bias, running_mean, running_var, eps: float,
                relu: bool, conv_bias=None):
    """Eval-mode y with torch ops: bf16(x scale + shift), then the ReLU;
    x with the bias `conv_bias` added first where given."""
    c = x.shape[1]
    scale, shift = _eval_coeffs(weight, bias, running_mean, running_var, eps)
    y = (_biased(x, conv_bias) * scale.view(1, c, 1, 1)
         + shift.view(1, c, 1, 1))
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _eval_pool_plain(x, weight, bias, running_mean, running_var, eps: float,
                     relu: bool, conv_bias=None):
    """The pooled eval pass with torch ops: each element of a 2x2 window
    (floor sizes), with the bias `conv_bias` added first where given,
    through x scale + shift and the ReLU in f32, the window's max, one
    bf16 rounding."""
    n, c, h, w = x.shape
    scale, shift = _eval_coeffs(weight, bias, running_mean, running_var, eps)
    win = _biased(x[:, :, :h // 2 * 2, :w // 2 * 2], conv_bias)
    y = win * scale.view(1, c, 1, 1) + shift.view(1, c, 1, 1)
    if relu:
        y = torch.clamp_min(y, 0.0)
    y = y.reshape(n, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))
    return y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _eval_cuda(x, weight, bias, running_mean, running_var, eps: float,
               relu: bool, conv_bias, pool: bool):
    n, c, h, w = x.shape
    f32 = [t.detach().to(torch.float32).contiguous()
           for t in (weight, bias, running_mean, running_var)]
    stats = torch.empty((5, 1, c), dtype=torch.float32, device=x.device)
    lib = build.load("episodic_batchnorm")
    if conv_bias is None and not pool:
        rows = n * h * w
        splits, per_split = eval_plan(rows, c)
        y = torch.empty_like(x, memory_format=torch.channels_last)
        name = "episodic_bn_eval_forward"
        fn = _ctypes(getattr(lib, name), 7,
                     [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_float, ctypes.c_int])
        args = [rows, c, splits, per_split]
    else:
        f32.append(None if conv_bias is None else
                   conv_bias.detach().to(torch.float32).contiguous())
        out = (n * (h // 2) * (w // 2), h // 2, w // 2) if pool else (
            n * h * w, h, w)
        splits, per_split = eval_plan(out[0], c, 4 if pool else 1)
        y = torch.empty((n, c) + out[1:], dtype=x.dtype, device=x.device,
                        memory_format=torch.channels_last)
        name = "episodic_bn_eval_epilogue_forward"
        fn = _ctypes(getattr(lib, name), 8,
                     [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_int])
        args = [n, h, w, c, int(pool), splits, per_split]
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in f32),
                 stats.data_ptr(), *args, float(eps), int(relu),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {build.error_name(err)}")
    if pool:
        episodic_batchnorm.eval_pool_launches += 1
    else:
        episodic_batchnorm.eval_launches += 1
    return y


def running_averages(running_mean, running_var, mean, var, unbiased_factor,
                     momentum: float):
    """The new running averages, new = (1 - m) old + m batch, from the
    batch mean and biased var [G, C]: each episode's update with the
    unbiased variance, averaged over the episodes."""
    unbiased = var * unbiased_factor
    m = momentum
    return ((1.0 - m) * running_mean + m * mean.mean(0),
            (1.0 - m) * running_var + m * unbiased.mean(0))


class _EpisodicBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, groups, eps,
                momentum, relu):
        fwd = _forward_cuda if x.is_cuda else _forward_plain
        y, stats = fwd(x, weight, bias, groups, eps, relu)
        # Here the small ops record the Function's own autograd sequence
        # number; after it, they would record the next op's, and a trace
        # reader would charge that op's backward to the BatchNorm.
        rows = x.numel() / (x.shape[1] * groups)
        new_mean, new_var = running_averages(
            running_mean, running_var, stats[0], stats[1],
            rows / max(rows - 1.0, 1.0), momentum)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.args = (groups, eps, relu)
        ctx.mark_non_differentiable(new_mean, new_var)
        return y, new_mean, new_var

    @staticmethod
    def backward(ctx, dy, *_):
        x, weight, bias, stats = ctx.saved_tensors
        groups, eps, relu = ctx.args
        if torch.is_grad_enabled():  # create_graph: a differentiable form
            dx, dw, db = _backward_plain(dy, x, weight, bias, None, groups,
                                         eps, relu)
        elif dy.is_cuda:
            dx, sums = _backward_cuda(dy, x, stats, groups, relu)
            dw, db = _param_grad(sums[1], weight), _param_grad(sums[0], bias)
        else:
            dx, dw, db = _backward_plain(dy, x, weight, bias, stats, groups,
                                         eps, relu)
        return (dx, dw, db) + (None,) * 6


def episodic_batchnorm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, running_mean: torch.Tensor,
                       running_var: torch.Tensor, groups: int,
                       eps: float = 1e-5, momentum: float = 0.1,
                       relu: bool = False):
    """Training-mode BatchNorm of bf16 x [G n, C, H, W] with statistics per
    episode (G = `groups`), then a ReLU where `relu`: (y [G n, C, H, W]
    bf16 in channels-last memory, the new running mean and var [C], f32
    and without gradients, by `running_averages`). weight and bias [C] are
    the f32 master parameters; the normalisation uses them rounded to
    bf16. CUDA tensors launch the kernels (a non-channels-last x is copied
    to channels-last first); CPU tensors take the plain torch version."""
    if not supports(x):
        raise ValueError(f"episodic_batchnorm takes bf16 [N, C, H, W] with C "
                         f"a multiple of {VEC} up to {MAX_C}; got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] % groups:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                         f"ep_groups={groups}")
    if x.is_cuda:
        x = _channels_last(x)
    return _EpisodicBatchNorm.apply(x, weight, bias, running_mean,
                                    running_var, int(groups), float(eps),
                                    float(momentum), bool(relu))


class _EvalLaunch(torch.autograd.Function):
    """`_eval_cuda` as an op of its own: a profiler links a kernel to the
    op it was launched in, and a launch in no op to none. It is taken only
    where no gradient is recorded, so it has no backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, relu,
                conv_bias, pool):
        return _eval_cuda(x, weight, bias, running_mean, running_var, eps,
                          relu, conv_bias, pool)


def episodic_batchnorm_eval(x: torch.Tensor, weight: torch.Tensor,
                            bias: torch.Tensor, running_mean: torch.Tensor,
                            running_var: torch.Tensor, eps: float = 1e-5,
                            relu: bool = False,
                            conv_bias: torch.Tensor | None = None,
                            pool: bool = False) -> torch.Tensor:
    """Eval-mode BatchNorm of bf16 x [N, C, H, W] by the running mean and
    var [C] (f32), then a ReLU where `relu`: y [N, C, H, W] bf16 in
    channels-last memory, bf16(x scale + shift) with scale = bf16(w)
    rsqrt(var + eps) and shift = bf16(b) - mean scale in f32; where x is
    a convolution's output made without its bias `conv_bias`, x stands
    for bf16(x + bf16(conv_bias)), the bias as ATen adds it. With `pool`,
    the 2x2 max-pool of stride 2 of that y, [N, C, H // 2, W // 2], the
    max taken in f32 before the one rounding. It records no gradient, and
    refuses inputs that would want one. CUDA tensors launch the kernels
    (a non-channels-last x is copied to channels-last first); CPU tensors
    take `_eval_plain` or `_eval_pool_plain`."""
    if not supports(x):
        raise ValueError(f"episodic_batchnorm_eval takes bf16 [N, C, H, W] "
                         f"with C a multiple of {VEC} up to {MAX_C}; got "
                         f"{x.dtype} {tuple(x.shape)}")
    if records_grad(x, weight, bias, conv_bias):
        raise ValueError("episodic_batchnorm_eval records no gradient; run "
                         "it under torch.no_grad()")
    if pool and min(x.shape[2:]) < 2:
        raise ValueError(f"a 2x2 max-pool takes maps of at least 2x2; got "
                         f"{tuple(x.shape)}")
    if not x.is_cuda:
        plain = _eval_pool_plain if pool else _eval_plain
        return plain(x, weight, bias, running_mean, running_var, eps, relu,
                     conv_bias)
    return _EvalLaunch.apply(_channels_last(x), weight, bias, running_mean,
                             running_var, float(eps), bool(relu), conv_bias,
                             bool(pool))


def batchnorm_torch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor, *,
                    train: bool, groups: int = 1, batch_sum=None,
                    eps: float = 1e-5, momentum: float = 0.1,
                    relu: bool = False):
    """BatchNorm over the channel axis (dim 1) of x [N, C, ...] of any
    float dtype in torch ops, then a ReLU where `relu`: (y in x's dtype,
    the new running mean and var [C] by `running_averages` in training
    mode, else None). Statistics are float32 for a float32 or
    lower-precision x, float64 for a float64 one; a float32 or float64 x
    takes the two-pass variance, a lower-precision one the one-pass
    E[x^2] - m^2 (JAX backbones.py:125-139). In training mode x is
    `groups` episodes laid out contiguously, each with its own statistics;
    `batch_sum`, where given, sums a tensor over the ranks that split the
    batch between them, and the statistics are then the whole batch's. In
    eval mode the running mean and var stand in for them."""
    c = x.shape[1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    spatial = (1,) * (x.dim() - 2)
    new = None
    if not train:
        mean = running_mean.view(1, c, *spatial)
        var = running_var.view(1, c, *spatial)
        y = (xf - mean) * torch.rsqrt(var + eps)
    else:
        if x.shape[0] % groups:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                             f"ep_groups={groups}")
        xg = xf.reshape(groups, x.shape[0] // groups, *x.shape[1:])
        axes = (1,) + tuple(range(3, xg.dim()))  # all but group and channel
        bshape = (groups, 1, c) + spatial
        n = torch.full((1, 1), xg[0].numel() / c, dtype=acc, device=x.device)
        if batch_sum is None:
            def average(v):
                return v.mean(dim=axes)
        else:  # the whole batch's statistics, its rows split over ranks
            n = batch_sum(n)

            def average(v):
                return batch_sum(v.sum(dim=axes)) / n
        mean = average(xg)  # [G, C]
        if x.dtype == acc:
            var = average(torch.square(xg - mean.view(bshape)))
        else:
            var = torch.clamp(average(torch.square(xg)) - torch.square(mean),
                              min=0.0)
        new = running_averages(running_mean, running_var, mean.detach(),
                               var.detach(), n / torch.clamp(n - 1.0, min=1.0),
                               momentum)
        y = ((xg - mean.view(bshape)) * torch.rsqrt(var.view(bshape) + eps)
             ).reshape(xf.shape)
    w = weight.to(x.dtype).to(acc).view(1, c, *spatial)
    b = bias.to(x.dtype).to(acc).view(1, c, *spatial)
    y = (y * w + b).to(x.dtype)
    return (F.relu(y) if relu else y), new


def batchnorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              running_mean: torch.Tensor, running_var: torch.Tensor, *,
              train: bool, groups: int = 1, batch_sum=None, eps: float = 1e-5,
              momentum: float = 0.1, relu: bool = False):
    """The BatchNorm(+ReLU) of models/backbones.py::EpisodicBatchNorm on
    the route that takes it: (y, the new running mean and var in training
    mode, else None). An input that `supports` takes, on a CUDA device,
    takes the training kernels (`episodic_batchnorm`) unless the ranks
    split the batch (`batch_sum` with groups 1), and in eval mode the eval
    kernel (`episodic_batchnorm_eval`) where its output records no
    gradient. Everything else takes `batchnorm_torch`; of the inputs that
    `supports` takes, the training ones are counted in
    `episodic_batchnorm.torch_route` and the CUDA eval ones in
    `.eval_torch_route`."""
    if groups != 1:
        batch_sum = None  # each rank's episodes are its own
    if supports(x):
        if train:
            if x.is_cuda and batch_sum is None:
                y, new_mean, new_var = episodic_batchnorm(
                    x, weight, bias, running_mean, running_var, groups, eps,
                    momentum, relu)
                return y, (new_mean, new_var)
            episodic_batchnorm.torch_route += 1
        elif x.is_cuda:
            if not records_grad(x, weight, bias):
                return episodic_batchnorm_eval(
                    x, weight, bias, running_mean, running_var, eps,
                    relu), None
            episodic_batchnorm.eval_torch_route += 1
    return batchnorm_torch(x, weight, bias, running_mean, running_var,
                           train=train, groups=groups, batch_sum=batch_sum,
                           eps=eps, momentum=momentum, relu=relu)


episodic_batchnorm.launches = 0  # kernel entry calls, forward and backward
episodic_batchnorm.torch_route = 0  # training calls that `supports` takes,
# left to torch
episodic_batchnorm.copies = 0  # layout copies of an input or a gradient
episodic_batchnorm.eval_launches = 0  # unpooled eval entry calls
episodic_batchnorm.eval_pool_launches = 0  # pooled eval epilogue entry calls
episodic_batchnorm.eval_torch_route = 0  # CUDA eval calls that `supports`
# takes, left to torch
