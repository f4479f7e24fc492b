"""Plain PyTorch reference of DKT's training step and eval head.

Written from the published method (Patacchiola et al., arXiv:1910.05199;
the reference code's methods/DKT.py with GPyTorch) and the precision law
the configuration states. It imports nothing of the program: the episode
sampling and the augmentation are worked out again from the seed's draws,
the trunk is functional torch, the GP is a dense Cholesky, the optimizer
is torch's Adam law written out.

`law` names the precision a call computes in:
  * "stated": what the configuration states. Convolutions in bfloat16
    from float32 master weights, BatchNorm statistics in float32, the GP
    and the augmentation's resampling in true float32 (TF32 off).
  * "control": one step below, the step a faster program would be
    tempted to take: float8 (e4m3) convolution inputs and weights, and
    TF32 products in the GP and the resampling (emulated by rounding the
    products' inputs to TF32's 10-bit mantissa, so the control reads the
    same on any device).
  * "float64": every part of the trunk, the head and the GP in float64,
    for the gradient that decides which leaves a step moves.
  * "onepass": as "stated", but each training-mode BatchNorm's variance
    in one pass, E[x^2] - mean^2 (clamped at 0), as the port and the JAX
    package compute it for a bfloat16 input: float32 statistics of equal
    standing, rounded otherwise; the witness of what round-off alone
    gives each number that `correct` compares.
Any other law computes as "stated".
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5
JITTER = (("Brightness", 0.4), ("Contrast", 0.4), ("Color", 0.4))
LUMA = (0.299, 0.587, 0.114)  # ITU-R 601-2, as PIL's convert("L")
LOG_2PI = math.log(2.0 * math.pi)


@contextlib.contextmanager
def no_tf32():
    """True float32 products and convolutions on the card."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _rounded(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q's values with x's gradient (a straight-through rounding)."""
    return x + (q - x).detach()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as the tensor cores read a TF32 product's inputs."""
    i = x.detach().contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return _rounded(x, r.view(torch.float32))


def matmul(a: torch.Tensor, b: torch.Tensor, law: str) -> torch.Tensor:
    """a @ b in float32: true float32, or with TF32 inputs."""
    if law == "control":
        a, b = tf32(a), tf32(b)
    with no_tf32():
        return a @ b


def mix(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run (split, weights,
    episodes, each protocol), from the run's seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) % (1 << 64)
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) % (1 << 64)
    x ^= x >> 32
    return x % (1 << 63)


# ------------------------------------------------------------ sampling


def sample_ids(table, counts, gen, n_way: int, k: int, batch: int):
    """[batch, n_way, k] image ids of a batch of episodes (the reference's
    data/dataset.py rules): n_way distinct classes, the first n_way of a
    random order; k images a class without replacement, the first k of a
    random order of the class's images, or with replacement where a class
    holds fewer than k. Draws: uniforms [batch, n_class], then uniforms
    [batch, n_way, width] over the class's slots."""
    n_class, width = table.shape
    dev = table.device
    order = torch.rand(batch, n_class, generator=gen, device=dev)
    ways = torch.argsort(order, dim=1)[:, :n_way]
    cnt = counts[ways]
    u = torch.rand(batch, n_way, width, generator=gen, device=dev)
    in_class = torch.arange(width, device=dev) < cnt[..., None]
    without = torch.argsort(torch.where(in_class, u, torch.inf), dim=-1)[..., :k]
    with_ = torch.minimum(torch.floor(u[..., :k] * cnt[..., None]).long(),
                          cnt[..., None] - 1)
    picks = torch.where((cnt >= k)[..., None], without, with_)
    return table[ways[..., None], picks]


# ---------------------------------------------------------- augmentation


def augment_draws(gen, n: int, canvas: int, out: int, device):
    """The draws of n images' augmentation, in their order: RandomSizedCrop
    (area in [0.08, 1] of the canvas, aspect in [3/4, 4/3], the first of
    ten valid draws, else the centred out x out window), the three jitter
    factors, the flip."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, 10, generator=gen, device=device)

    area = uniform(0.08, 1.0) * (canvas * canvas)
    aspect = torch.exp(uniform(math.log(3.0 / 4.0), math.log(4.0 / 3.0)))
    cw = torch.round(torch.sqrt(area * aspect))
    ch = torch.round(torch.sqrt(area / aspect))
    ok = (cw > 0) & (cw <= canvas) & (ch > 0) & (ch <= canvas)
    first = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)
    cw, ch = cw.gather(1, first)[:, 0], ch.gather(1, first)[:, 0]
    u_left = torch.rand(n, 10, generator=gen, device=device).gather(1, first)
    u_top = torch.rand(n, 10, generator=gen, device=device).gather(1, first)
    left = torch.floor(u_left[:, 0] * (canvas - cw + 1))
    top = torch.floor(u_top[:, 0] * (canvas - ch + 1))
    any_ok = ok.any(dim=1)
    centre = float((canvas - out) // 2)
    left = torch.where(any_ok, left, centre)
    top = torch.where(any_ok, top, centre)
    cw = torch.where(any_ok, cw, float(out))
    ch = torch.where(any_ok, ch, float(out))
    alphas = torch.tensor([a for _, a in JITTER], device=device)
    u = torch.rand(n, len(JITTER), generator=gen, device=device)
    flip = torch.rand(n, generator=gen, device=device) < 0.5
    return left, top, cw, ch, alphas * (u * 2.0 - 1.0) + 1.0, flip


def resample_weights(start, length, out: int, size: int):
    """[n, out, size] weights of a linear, antialiased resize of the crop
    [start, start + length) of an axis of `size` pixels to `out` pixels
    (jax.image.scale_and_translate, method="linear"): a triangle filter
    widened by the downscale factor, each output's weights normalised, a
    sample centre outside the axis giving zeros."""
    dev = start.device
    step = (length / out)[:, None, None]
    width = torch.clamp(step, min=1.0)
    centre = ((torch.arange(out, dtype=torch.float32, device=dev)[None, :, None]
               + 0.5) * step + start[:, None, None] - 0.5)
    pix = torch.arange(size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(centre - pix) / width, min=0.0)
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where((centre >= -0.5) & (centre <= size - 0.5), w, 0.0)


def augment(images_u8, draws, out: int, law: str = "stated"):
    """[n, canvas, canvas, 3] uint8 -> [n, out, out, 3] uint8: crop and
    resize, PIL's Brightness, Contrast and Color enhancers in that order,
    the flip, rounding half to even."""
    left, top, cw, ch, factors, flip = draws
    n, h, w, c = images_u8.shape
    x = images_u8.to(torch.float32)
    rows = resample_weights(top, ch, out, h)
    cols = resample_weights(left, cw, out, w)
    t = matmul(rows, x.reshape(n, h, w * c), law)          # [n, out, w*c]
    t = t.reshape(n, out, w, c).transpose(1, 2).reshape(n, w, out * c)
    x = matmul(cols, t, law).reshape(n, out, out, c).transpose(1, 2)
    luma_w = torch.tensor(LUMA, device=x.device)
    for i, (name, _) in enumerate(JITTER):
        f = factors[:, i, None, None, None]
        if name == "Brightness":
            base = torch.zeros_like(x)
        elif name == "Contrast":
            base = torch.round((x * luma_w).sum(-1).mean(dim=(1, 2)))
            base = base[:, None, None, None].expand_as(x)
        else:
            base = (x * luma_w).sum(-1, keepdim=True).expand_as(x)
        x = torch.clamp(base * (1.0 - f) + x * f, 0.0, 255.0)
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


# ------------------------------------------------------------- trunk parts


def preprocess(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, /255 and ImageNet-normalised."""
    x = x_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def trunk_dtype(law: str) -> torch.dtype:
    """The dtype the trunk's layers compute in under the law."""
    return torch.float64 if law == "float64" else torch.bfloat16


def low(x: torch.Tensor, law: str) -> torch.Tensor:
    """A convolution's operand in the law's precision: bfloat16, float8
    e4m3 carried in bfloat16, or float64."""
    x = x.to(trunk_dtype(law))
    if law == "control":
        x = _rounded(x, x.detach().to(torch.float8_e4m3fn).to(torch.bfloat16))
    return x


def conv(p: dict, name: str, x, law: str, stride: int = 1, padding: int = 0):
    """A convolution in the law's precision, from float32 master weights."""
    bias = p.get(name + ".bias")
    if bias is not None:
        bias = bias.to(trunk_dtype(law))
    return F.conv2d(low(x, law), low(p[name + ".weight"], law), bias,
                    stride, padding)


def batchnorm(p: dict, name: str, x, train: bool, groups: int, stats: dict,
              law: str = "stated"):
    """BatchNorm over dim 1 of a bfloat16 x: batch statistics of each of
    `groups` episodes in float32 (two passes) in training, the running
    averages otherwise; the scale and shift cast to bfloat16 as every
    layer's weights are; the result in bfloat16 (a float64 x keeps
    float64 throughout). In training stats[name]
    gets the new running averages: torch's update with momentum 0.1 and
    the unbiased variance, each episode's averaged over the episodes."""
    c = x.shape[1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    shape = (1, c) + (1,) * (x.dim() - 2)
    if train:
        xg = xf.reshape((groups, -1) + tuple(xf.shape[1:]))
        dims = (1,) + tuple(range(3, xg.dim()))
        mean = xg.mean(dim=dims)                                # [G, C]
        if law == "onepass":
            var = torch.clamp((xg * xg).mean(dim=dims) - mean * mean, min=0.0)
        else:
            var = ((xg - mean.view((groups, 1, c) + shape[2:])) ** 2
                   ).mean(dim=dims)
        count = xg[0].numel() / c
        m = BN_MOMENTUM
        stats[name] = (
            (1 - m) * p[name + ".running_mean"] + m * mean.detach().mean(0),
            (1 - m) * p[name + ".running_var"]
            + m * (var.detach() * count / max(count - 1.0, 1.0)).mean(0))
        gshape = (groups, 1, c) + shape[2:]
        y = ((xg - mean.view(gshape)) / torch.sqrt(var.view(gshape) + BN_EPS)
             ).reshape(xf.shape)
    else:
        y = ((xf - p[name + ".running_mean"].view(shape))
             / torch.sqrt(p[name + ".running_var"].view(shape) + BN_EPS))
    w = p[name + ".weight"].to(x.dtype).to(acc).view(shape)
    b = p[name + ".bias"].to(x.dtype).to(acc).view(shape)
    return (y * w + b).to(x.dtype)


def bncossim(p: dict, z, train: bool, groups: int, stats: dict,
             law: str = "stated"):
    """The bncossim head: BatchNorm1d over the flat features, then float32
    (or float64) and L2 normalisation."""
    z = batchnorm(p, "feature.trunk.bn_out", z, train, groups, stats, law)
    z = z.to(torch.promote_types(z.dtype, torch.float32))
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)


# --------------------------------------------------------------------- GP


def ovr_targets(n_way: int, k: int, device) -> torch.Tensor:
    """[n_way, n_way*k]: +1 on way w's k points, -1 elsewhere."""
    labels = torch.arange(n_way, device=device).repeat_interleave(k)
    return torch.where(labels[None, :] == torch.arange(
        n_way, device=device)[:, None], 1.0, -1.0)


def gp_mll(p: dict, z, n_way: int, n_total: int, noise: float, law: str):
    """[B, W] exact marginal log-likelihoods, divided by N as GPyTorch's
    ExactMarginalLogLikelihood does, of the one-vs-rest targets under
    K_w = s_w Z Z^T + noise I, s_w = softplus(raw outputscale), constant
    mean c_w; z [B, N, D]."""
    n = z.shape[1]
    y = ovr_targets(n_way, n_total, z.device) - p["gp.mean.constant"][:, None]
    s = F.softplus(p["gp.kernel.raw_outputscale"])
    gram = matmul(z, z.transpose(1, 2), law)                  # [B, N, N]
    eye = torch.eye(n, device=z.device)
    k = s[None, :, None, None] * gram[:, None] + noise * eye
    with no_tf32():
        chol = torch.linalg.cholesky(k)
        alpha = torch.cholesky_solve(
            y[None, :, :, None].expand(z.shape[0], -1, -1, -1), chol)[..., 0]
    quad = (y[None] * alpha).sum(-1)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (quad + logdet + n * LOG_2PI) / n


def gp_posterior_mean(p: dict, z, n_way: int, n_support: int, noise: float,
                      law: str):
    """[B, W*Q, W] posterior means at the queries, each way's GP
    conditioned on the support set; z [B, W*(S+Q), D] in way-major
    order."""
    b, _, d = z.shape
    zw = z.reshape(b, n_way, -1, d)
    zs = zw[:, :, :n_support].reshape(b, -1, d)
    zq = zw[:, :, n_support:].reshape(b, -1, d)
    c = p["gp.mean.constant"]
    y = ovr_targets(n_way, n_support, z.device) - c[:, None]
    s = F.softplus(p["gp.kernel.raw_outputscale"])
    k_ss = s[None, :, None, None] * matmul(zs, zs.transpose(1, 2), law)[:, None]
    k_sq = s[None, :, None, None] * matmul(zs, zq.transpose(1, 2), law)[:, None]
    k_ss = k_ss + noise * torch.eye(zs.shape[1], device=z.device)
    with no_tf32():
        chol = torch.linalg.cholesky(k_ss)
        alpha = torch.cholesky_solve(
            y[None, :, :, None].expand(b, -1, -1, -1), chol)
    mean = c[None, :, None] + matmul(k_sq.transpose(-1, -2), alpha, law)[..., 0]
    return mean.transpose(1, 2)


# ------------------------------------------------------------------- Adam


def adam(params: dict, grads: dict, state: dict, lrs: dict, t: int,
         betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One step of torch.optim.Adam's law in place: m and v moments, both
    bias-corrected, eps outside the square root."""
    b1, b2 = betas
    with torch.no_grad():
        for name, g in grads.items():
            m, v = state.setdefault(name, (torch.zeros_like(g),
                                           torch.zeros_like(g)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(1 - b2 ** t) + eps
            params[name].sub_(lrs[name] / (1 - b1 ** t) * m / denom)
