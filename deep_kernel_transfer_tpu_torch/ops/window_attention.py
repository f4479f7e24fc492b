"""Shifted-window multi-head self-attention with a relative-position bias
table (Swin Transformer), forward and backward: `csrc/window_attention.cu`
on the card, `window_attention_torch` (the plain torch chain, the kernel's
test reference) everywhere else.

Replaces no Pallas kernel: the JAX package has no transformer trunk.
`window_attention` takes the output of a block's qkv product, qkv [N, T, 3C]
in token order of the h x w map (T = h w, C = heads x head width), and
returns the attention's output o [N, T, C] in the same order, before the
output projection. For each window of M x M tokens of the map cyclically
shifted by `shift` rows and columns towards the origin, and each head:

    s = (q k^T) / sqrt(d) + bf16(B)[index] + mask     (f32, or f64 for f64)
    o = bf16(softmax(s)) v                             (the products' sums
                                                        f32, o in qkv's dtype)

where B [(2M - 1)^2, heads] is the bias table, `index` [M^2, M^2] its row
for each pair of a window's tokens (`relative_index`), and `mask`
[windows, M^2, M^2] -100 for pairs from different regions of the shifted
map (`shift_mask`; none without a shift). The chain builds the index and
the mask once a geometry and device; the kernel computes the index, the
regions, the shift and the window partition from the tokens' coordinates
and keeps each window's scores on chip; its backward recomputes them and
writes dq, dk and dv into one [N, T, 3C] gradient and each CTA's sum of
the table's gradient, summed here in order.

Route: a bf16 CUDA qkv whose heads are 32 wide, with windows of at most
8 x 8 that tile the map, takes the kernels (`window_attention.launches`
counts each forward and each backward launch: two a block a training
step). Every other CUDA call takes the chain and is counted in
`window_attention.torch_route`; CPU tensors take the chain uncounted.
Under create_graph the kernels' backward is replaced by the chain's,
with grad mode on so that higher derivatives follow, and counted in
`window_attention.torch_route`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

HEAD_DIM = 32  # the kernel's head width
MAX_WINDOW = 8  # M^2 <= 64 tokens: four warps of 16 query rows
MASK_VALUE = -100.0
# Windows a CTA walks in turn, at most: enough CTAs for many waves on the
# card's 132 SMs, so that the last wave's tail is short, and few enough
# that the backward's per-CTA sums of the table's gradient stay small.
WINDOWS_PER_CTA = 8


def relative_index(window: int, device=None) -> torch.Tensor:
    """[M^2, M^2] int64: the bias table's row for query a and key b of a
    window, (a_i - b_i + M - 1)(2M - 1) + (a_j - b_j + M - 1)."""
    ij = torch.stack(torch.meshgrid(torch.arange(window, device=device),
                                    torch.arange(window, device=device),
                                    indexing="ij")).flatten(1)
    rel = ij[:, :, None] - ij[:, None, :] + window - 1
    return rel[0] * (2 * window - 1) + rel[1]


def shift_mask(h: int, w: int, window: int, shift: int,
               device=None) -> torch.Tensor | None:
    """[windows, M^2, M^2] f32 of an h x w map cyclically shifted by `shift`:
    -100 where query and key lie in different regions of the shifted map
    (rows [0, h - M), [h - M, h - shift), [h - shift, h), and so for
    columns), else 0; None without a shift."""
    if not shift:
        return None
    def regions(size):
        v = torch.arange(size, device=device)
        return (v >= size - window).long() + (v >= size - shift).long()

    ids = regions(h)[:, None] * 3 + regions(w)[None, :]
    ids = (ids.view(h // window, window, w // window, window)
           .permute(0, 2, 1, 3).reshape(-1, window * window))
    return torch.where(ids[:, None, :] != ids[:, :, None],
                       torch.tensor(MASK_VALUE, device=device),
                       torch.tensor(0.0, device=device))


@functools.lru_cache(maxsize=None)
def _index_and_mask(h: int, w: int, window: int, shift: int,
                    device: torch.device):
    return relative_index(window, device), shift_mask(h, w, window, shift,
                                                      device)


def window_attention_torch(qkv: torch.Tensor, table: torch.Tensor,
                           heads: int, window: int, shift: int,
                           size: tuple[int, int]) -> torch.Tensor:
    """The attention in torch ops, differentiable: roll, window partition,
    f32 (f64 for an f64 qkv) scores with the table rounded to qkv's dtype
    and the mask added, softmax, the probabilities rounded to qkv's dtype,
    the product with v, reverse partition, roll back."""
    n, t, c3 = qkv.shape
    h, w = size
    index, mask = _index_and_mask(h, w, window, shift, qkv.device)
    c, m = c3 // 3, window
    d, nw, length = c // heads, (h // m) * (w // m), m * m
    acc = torch.promote_types(qkv.dtype, torch.float32)
    x = qkv.reshape(n, h, w, c3)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    x = (x.reshape(n, h // m, m, w // m, m, 3, heads, d)
         .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, n * nw, heads, length, d))
    q, k, v = x.to(acc).unbind(0)
    s = (q @ k.transpose(-1, -2)) * d ** -0.5
    s = s + table.to(qkv.dtype).to(acc)[index].permute(2, 0, 1)
    if mask is not None:
        s = (s.view(n, nw, heads, length, length)
             + mask.to(acc)[:, None]).view(n * nw, heads, length, length)
    p = torch.softmax(s, dim=-1).to(qkv.dtype)
    o = (p.to(acc) @ v).to(qkv.dtype)
    o = (o.view(n, h // m, w // m, heads, m, m, d)
         .permute(0, 1, 4, 2, 5, 3, 6).reshape(n, h, w, c))
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o.reshape(n, t, c)


def supports(qkv: torch.Tensor, heads: int, window: int,
             size: tuple[int, int]) -> bool:
    """Whether the kernels take the call: bf16 qkv [N, h w, 3 x 32 heads],
    windows of at most 8 x 8 that tile the h x w map."""
    h, w = size
    return (qkv.dtype == torch.bfloat16 and qkv.dim() == 3
            and qkv.shape[0] > 0 and qkv.shape[1] == h * w
            and qkv.shape[2] == 3 * HEAD_DIM * heads
            and 1 <= window <= MAX_WINDOW and h % window == 0
            and w % window == 0)


def ctas(n: int, h: int, w: int, window: int) -> int:
    """CTAs of a head's launch: one for each WINDOWS_PER_CTA windows."""
    return -(-n * (h // window) * (w // window) // WINDOWS_PER_CTA)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _entry(name: str, n_ptr: int):
    fn = getattr(build.load("window_attention"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, ptrs: list, geometry: tuple, device) -> None:
    fn = _entry(name, len(ptrs))
    with torch.cuda.device(device):
        err = fn(*ptrs, *geometry, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {build.error_name(err)}")
    window_attention.launches += 1


def _forward_cuda(qkv, table, geometry):
    n, t, c3 = qkv.shape
    out = torch.empty((n, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    _launch("window_attention_forward",
            [qkv.data_ptr(), table.data_ptr(), out.data_ptr()], geometry,
            qkv.device)
    return out


def _backward_cuda(do, qkv, table, geometry):
    heads, window, blocks = geometry[3], geometry[4], geometry[6]
    rows = (2 * window - 1) ** 2
    do = _aligned(do)
    dqkv = torch.empty_like(qkv)
    part = torch.empty((heads, blocks, rows), dtype=torch.float32,
                       device=qkv.device)
    _launch("window_attention_backward",
            [qkv.data_ptr(), table.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
             part.data_ptr()], geometry, qkv.device)
    return dqkv, part.sum(1).t().to(table.dtype)


class _WindowAttention(torch.autograd.Function):
    """The kernels as an op of their own, so that a profiler charges their
    launches to the spans they run in. `table` is the bf16 table."""

    @staticmethod
    def forward(ctx, qkv, table, heads, window, shift, h, w):
        geometry = (qkv.shape[0], h, w, heads, window, shift,
                    ctas(qkv.shape[0], h, w, window))
        ctx.save_for_backward(qkv, table)
        ctx.args = (heads, window, shift, (h, w), geometry)
        return _forward_cuda(qkv, table, geometry)

    @staticmethod
    def backward(ctx, do):
        qkv, table = ctx.saved_tensors
        heads, window, shift, size, geometry = ctx.args
        if torch.is_grad_enabled():  # create_graph: a differentiable form
            window_attention.torch_route += 1
            o = window_attention_torch(qkv, table, heads, window, shift, size)
            dqkv, dtable = torch.autograd.grad(o, (qkv, table), do,
                                               create_graph=True)
        else:
            dqkv, dtable = _backward_cuda(do, qkv, table, geometry)
        return (dqkv, dtable) + (None,) * 5


def window_attention(qkv: torch.Tensor, table: torch.Tensor, heads: int,
                     window: int, shift: int,
                     size: tuple[int, int]) -> torch.Tensor:
    """o [N, T, C] of qkv [N, T, 3C] (see the module docstring): the
    kernels for a CUDA qkv that `supports` takes, else
    `window_attention_torch`. `table` is the f32 master table
    [(2M - 1)^2, heads], rounded to qkv's dtype on either route."""
    if qkv.is_cuda and supports(qkv, heads, window, size):
        return _WindowAttention.apply(
            _aligned(qkv), _aligned(table.to(torch.bfloat16)), int(heads),
            int(window), int(shift), int(size[0]), int(size[1]))
    if qkv.is_cuda:
        window_attention.torch_route += 1
    return window_attention_torch(qkv, table, heads, window, shift, size)


window_attention.launches = 0  # kernel launches, forward and backward
# CUDA calls left to the torch chain, and kernel backwards replaced by the
# chain's under create_graph
window_attention.torch_route = 0
