"""Swin-T (Liu et al., Swin Transformer: Hierarchical Vision Transformer
using Shifted Windows, arXiv:2103.14030, Table 1; the official
swin_tiny_patch4_window7_224 configuration) in its published form, plain
torch: a 4x4/4 patch embedding to C = 96 channels with LayerNorm, then four
stages of 2, 2, 6 and 2 blocks at C = 96, 192, 384 and 768 with 3, 6, 12
and 24 heads of width 32 in 7x7 windows, a patch merging between stages,
the final LayerNorm and the mean over the tokens (224 px -> 7 x 7 tokens ->
768).

A block: x + attn(LN1(x)), then x + fc2(GELU(fc1(LN2(x)))) with an MLP of
ratio 4 and exact GELU. attn, in every second block of a stage with its
windows shifted: the map cyclically rolled by -3 rows and columns
(torch.roll), partitioned into 7x7 windows, the qkv product, q scaled by
32^-0.5, q k^T, the bias table [169, heads] gathered by the relative
position index and added, the -100 mask added between tokens from
different regions of the rolled map, the softmax, the product with v, the
output projection, the windows put back and the map rolled by +3. Stage
4's 7 x 7 map is one window, so it takes no shift. A patch merging
concatenates each 2x2 neighbourhood's tokens (rows 0::2 and 1::2 of column
0::2, then of column 1::2), takes LayerNorm over the 4C channels and a
linear map to 2C without bias.

Precision (reference/common.py's laws): the products' operands in the
law's precision (`low`), LayerNorm statistics and the softmax in float32
(float64 under that law), the scale and shift of a LayerNorm, the biases
and the bias table cast to the trunk's dtype as every layer's weights are.

Departures from the paper:
  * stochastic depth (the published drop_path_rate 0.2) and dropout are
    left out (rate 0), as in the program: the comparison redoes the
    program's steps from the same draws, and a mask drawn apart would
    differ;
  * no absolute position embedding (Swin-T has none; ape=False).

Under grad each block runs through torch.utils.checkpoint
(use_reentrant=False): its activations are recomputed in the backward, so
that three bfloat16 steps at 840 images and the float64 gradient fit on
one card. The recompute runs the same operations in the same order.

`SPEC` holds the published sizes; every function takes `spec=` so that
tests can run a tiny one.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import conv, low, preprocess, trunk_dtype

SPEC = {"patch": 4, "dim": 96, "depths": (2, 2, 6, 2),
        "heads": (3, 6, 12, 24), "window": 7, "mlp_ratio": 4}
LN_EPS = 1e-5
MASK = -100.0
PRE = "feature.trunk"


def _layers(size: int, spec: dict):
    """(index, kind, sizes) of each layer of the trunk's list in order:
    ("embed", (dim, res)), ("block", (dim, heads, res, window, shift)),
    ("merge", (dim, res)), ("norm", (dim,)); res is the layer's input map
    side."""
    res, dim = size // spec["patch"], spec["dim"]
    out = [("embed", (dim, res))]
    for s, (depth, heads) in enumerate(zip(spec["depths"], spec["heads"])):
        m = min(spec["window"], res)
        shift = 0 if res <= spec["window"] else spec["window"] // 2
        out += [("block", (dim, heads, res, m, shift if j % 2 else 0))
                for j in range(depth)]
        if s < len(spec["depths"]) - 1:
            out.append(("merge", (dim, res)))
            res, dim = res // 2, 2 * dim
    out.append(("norm", (dim,)))
    return list(enumerate(out))


def feat_dim(size: int, spec: dict = SPEC) -> int:
    return spec["dim"] * 2 ** (len(spec["depths"]) - 1)


def _ln(shapes: dict, name: str, c: int) -> None:
    shapes[f"{name}.weight"] = ((c,), "ln_weight")
    shapes[f"{name}.bias"] = ((c,), "ln_bias")


def _lin(shapes: dict, name: str, out: int, cin: int, bias: bool = True):
    shapes[f"{name}.weight"] = ((out, cin), "linear")
    if bias:
        shapes[f"{name}.bias"] = ((out,), "linear_bias")


def param_shapes(size: int, spec: dict = SPEC) -> dict:
    """name -> (shape, kind), in the program's state_dict names."""
    shapes, k = {}, spec["patch"]
    for i, (kind, sizes) in _layers(size, spec):
        pre = f"{PRE}.{i}"
        if kind == "embed":
            shapes[f"{pre}.proj.weight"] = ((sizes[0], 3, k, k), "conv")
            shapes[f"{pre}.proj.bias"] = ((sizes[0],), "conv_bias")
            _ln(shapes, f"{pre}.norm", sizes[0])
        elif kind == "block":
            c, heads, _, m, _ = sizes
            _ln(shapes, f"{pre}.norm1", c)
            shapes[f"{pre}.attn.relative_position_bias_table"] = (
                ((2 * m - 1) ** 2, heads), "table")
            _lin(shapes, f"{pre}.attn.qkv", 3 * c, c)
            _lin(shapes, f"{pre}.attn.proj", c, c)
            _ln(shapes, f"{pre}.norm2", c)
            _lin(shapes, f"{pre}.mlp.fc1", spec["mlp_ratio"] * c, c)
            _lin(shapes, f"{pre}.mlp.fc2", c, spec["mlp_ratio"] * c)
        elif kind == "merge":
            _ln(shapes, f"{pre}.norm", 4 * sizes[0])
            _lin(shapes, f"{pre}.reduction", 2 * sizes[0], 4 * sizes[0],
                 bias=False)
        else:
            _ln(shapes, f"{pre}.norm", sizes[0])
    return shapes


def attention_shapes(size: int, spec: dict = SPEC) -> list[tuple]:
    """(tokens, channels, heads, window, shifted) of each block's attention
    for one image, in order."""
    return [(res * res, c, heads, m, bool(shift))
            for _, (kind, sizes) in _layers(size, spec) if kind == "block"
            for c, heads, res, m, shift in [sizes]]


def macs(size: int, spec: dict = SPEC) -> list[int]:
    """Forward multiply-adds of each product for one image, in order: the
    patch embedding; each block's qkv, Q K^T and A V over its windows (T
    tokens x M^2 keys x C), the output projection, the MLP's two layers;
    each merging's reduction."""
    out, r = [], spec["mlp_ratio"]
    for _, (kind, sizes) in _layers(size, spec):
        if kind == "embed":
            c, res = sizes
            out.append(res * res * c * 3 * spec["patch"] ** 2)
        elif kind == "block":
            c, _, res, m, _ = sizes
            t = res * res
            out += [t * c * 3 * c, t * m * m * c, t * m * m * c, t * c * c,
                    t * c * r * c, t * r * c * c]
        elif kind == "merge":
            c, res = sizes
            out.append((res // 2) ** 2 * 4 * c * 2 * c)
    return out


def _layer_norm(p, name, x):
    """LayerNorm over the last dim in float32 (float64 for a float64 x),
    the scale and shift cast to x's dtype as every layer's weights are."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w = p[name + ".weight"].to(x.dtype).to(acc)
    b = p[name + ".bias"].to(x.dtype).to(acc)
    return F.layer_norm(x.to(acc), (x.shape[-1],), w, b, LN_EPS).to(x.dtype)


def _linear(p, name, x, law):
    bias = p.get(name + ".bias")
    if bias is not None:
        bias = bias.to(trunk_dtype(law))
    return F.linear(low(x, law), low(p[name + ".weight"], law), bias)


def relative_index(m: int, device) -> torch.Tensor:
    """[M^2, M^2]: the bias table's row for each (query, key) pair of a
    window, as the official code builds it."""
    coords = torch.stack(torch.meshgrid(torch.arange(m, device=device),
                                        torch.arange(m, device=device),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + (m - 1)
    return rel[:, :, 0] * (2 * m - 1) + rel[:, :, 1]


def _partition(x, m):
    """[n, H, W, C] -> [n * windows, M^2, C]."""
    n, h, w, c = x.shape
    return (x.view(n, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(-1, m * m, c))


def _reverse(x, m, h, w):
    """[n * windows, M^2, C] -> [n, H, W, C]."""
    c = x.shape[-1]
    return (x.view(-1, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(-1, h, w, c))


def attention_mask(res: int, m: int, shift: int, device) -> torch.Tensor:
    """[windows, M^2, M^2]: -100 between tokens from different regions of
    the rolled map, 0 elsewhere (the official img_mask and its slices)."""
    img = torch.zeros(1, res, res, 1, device=device)
    cuts = (slice(0, -m), slice(-m, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = cnt
            cnt += 1
    ids = _partition(img, m).view(-1, m * m)
    diff = ids[:, None, :] - ids[:, :, None]
    return torch.where(diff != 0, torch.tensor(MASK, device=device),
                       torch.tensor(0.0, device=device))


def _attention(p, pre, x, heads, res, m, shift, law):
    """The shifted-window attention of LN1's output x [n, T, C]."""
    n, t, c = x.shape
    d, length = c // heads, m * m
    acc = torch.promote_types(x.dtype, torch.float32)
    h = x.view(n, res, res, c)
    if shift:
        h = torch.roll(h, (-shift, -shift), (1, 2))
    win = _partition(h, m)
    qkv = (_linear(p, f"{pre}.attn.qkv", win, law)
           .reshape(-1, length, 3, heads, d).permute(2, 0, 3, 1, 4))
    q, k, v = qkv[0] * d ** -0.5, qkv[1], qkv[2]
    a = (low(q, law) @ low(k, law).transpose(-2, -1)).to(acc)
    table = p[f"{pre}.attn.relative_position_bias_table"].to(x.dtype).to(acc)
    a = a + table[relative_index(m, x.device)].permute(2, 0, 1)[None]
    if shift:
        mask = attention_mask(res, m, shift, x.device).to(acc)
        a = (a.view(n, -1, heads, length, length)
             + mask[None, :, None]).view(-1, heads, length, length)
    a = torch.softmax(a, dim=-1).to(x.dtype)
    o = (low(a, law) @ low(v, law)).transpose(1, 2).reshape(-1, length, c)
    o = _reverse(_linear(p, f"{pre}.attn.proj", o, law), m, res, res)
    if shift:
        o = torch.roll(o, (shift, shift), (1, 2))
    return o.reshape(n, t, c)


def _block(p, pre, heads, res, m, shift, law, x):
    x = x + _attention(p, pre, _layer_norm(p, f"{pre}.norm1", x), heads, res,
                       m, shift, law)
    h = _linear(p, f"{pre}.mlp.fc1", _layer_norm(p, f"{pre}.norm2", x), law)
    return x + _linear(p, f"{pre}.mlp.fc2", F.gelu(h), law)


def _merge(p, pre, res, law, x):
    n, _, c = x.shape
    x = x.view(n, res, res, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1).view(n, -1, 4 * c)
    return _linear(p, f"{pre}.reduction", _layer_norm(p, f"{pre}.norm", x),
                   law)


def forward(p: dict, x_u8, train: bool, groups: int, law: str, stats: dict,
            spec: dict = SPEC):
    """Features [N, D] in the trunk's dtype of uint8 images [N, H, W, 3]; no
    BatchNorm, so `train`, `groups` and `stats` change nothing. Each block
    is recomputed in the backward under grad."""
    x = preprocess(x_u8).to(trunk_dtype(law))
    for i, (kind, sizes) in _layers(x.shape[-1], spec):
        pre = f"{PRE}.{i}"
        if kind == "embed":
            x = conv(p, f"{pre}.proj", x, law, stride=spec["patch"])
            x = _layer_norm(p, f"{pre}.norm", x.flatten(2).transpose(1, 2))
        elif kind == "block":
            _, heads, res, m, shift = sizes
            block = functools.partial(_block, p, pre, heads, res, m, shift,
                                      law)
            x = (checkpoint(block, x, use_reentrant=False)
                 if torch.is_grad_enabled() else block(x))
        elif kind == "merge":
            x = _merge(p, pre, sizes[1], law, x)
        else:
            x = _layer_norm(p, f"{pre}.norm", x).mean(dim=1)
    return x

