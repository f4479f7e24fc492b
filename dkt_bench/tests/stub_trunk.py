"""A stub transformer trunk for the harness's tests, loaded by them as
`dkt_bench.reference.trunk_Stub`: what a trunk module of a transformer
gives the reference and the yardstick, at a size the CPU runs in a
second. No cell and no configuration uses it.

16 px images: a 4x4/4 patch embedding with LayerNorm (4 x 4 = 16 tokens
of WIDTH channels), one pre-LN block (LayerNorm, multi-head attention
within 2x2 windows with a learned relative-position bias table, a
layer scale, the residual; LayerNorm, a GELU MLP of ratio 4, the
residual), a final LayerNorm and the mean over tokens (D = WIDTH). The
layer scale has a kind of its own, `stub_scale`, drawn by `draw_leaf`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dkt_bench.reference.common import conv, low, preprocess, trunk_dtype

PATCH = 4
WIDTH = 32
HEADS = 2
WINDOW = 2
MLP_RATIO = 4
LN_EPS = 1e-5
PRE = "feature.trunk"


def _tokens(size: int) -> int:
    return (size // PATCH) ** 2


def feat_dim(size: int) -> int:
    return WIDTH


def param_shapes(size: int) -> dict:
    """name -> (shape, kind)."""
    c, h = WIDTH, MLP_RATIO * WIDTH
    shapes = {f"{PRE}.patch.weight": ((c, 3, PATCH, PATCH), "conv"),
              f"{PRE}.patch.bias": ((c,), "conv_bias")}
    for ln in ("patch_norm", "norm1", "norm2", "norm"):
        shapes[f"{PRE}.{ln}.weight"] = ((c,), "ln_weight")
        shapes[f"{PRE}.{ln}.bias"] = ((c,), "ln_bias")
    for name, (out, cin) in (("qkv", (3 * c, c)), ("proj", (c, c)),
                             ("fc1", (h, c)), ("fc2", (c, h))):
        shapes[f"{PRE}.{name}.weight"] = ((out, cin), "linear")
        shapes[f"{PRE}.{name}.bias"] = ((out,), "linear_bias")
    shapes[f"{PRE}.bias_table"] = (((2 * WINDOW - 1) ** 2, HEADS), "table")
    shapes[f"{PRE}.scale"] = ((c,), "stub_scale")
    return shapes


def draw_leaf(kind, shape, z, u, trained):
    """The layer scale: 0.5 initially, U(0.25, 0.75) trained."""
    if kind == "stub_scale":
        return 0.25 + 0.5 * u if trained else torch.full_like(z, 0.5)
    return None


def macs(size: int) -> list[int]:
    """Forward multiply-adds of each product for one image, in order: the
    patch embedding, qkv, Q K^T and A V over each window, the output
    projection, the MLP's two layers."""
    t, c, m2 = _tokens(size), WIDTH, WINDOW * WINDOW
    return [t * 3 * c * PATCH * PATCH, t * c * 3 * c, t * m2 * c,
            t * m2 * c, t * c * c, t * c * MLP_RATIO * c,
            t * MLP_RATIO * c * c]


def _layer_norm(p, name, x):
    """LayerNorm over the last dim in float32 (float64 for a float64 x),
    the scale and shift cast to x's dtype as every layer's weights are."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w = p[name + ".weight"].to(x.dtype).to(acc)
    b = p[name + ".bias"].to(x.dtype).to(acc)
    return F.layer_norm(x.to(acc), (x.shape[-1],), w, b, LN_EPS).to(x.dtype)


def _linear(p, name, x, law):
    return F.linear(low(x, law), low(p[name + ".weight"], law),
                    p[name + ".bias"].to(trunk_dtype(law)))


def _relative_index(device) -> torch.Tensor:
    """[M^2, M^2] rows of the bias table for each pair of a window's
    tokens."""
    ij = torch.stack(torch.meshgrid(torch.arange(WINDOW, device=device),
                                    torch.arange(WINDOW, device=device),
                                    indexing="ij")).flatten(1)
    rel = ij[:, :, None] - ij[:, None, :] + WINDOW - 1
    return rel[0] * (2 * WINDOW - 1) + rel[1]


def _attention(p, x, side, law):
    """Multi-head self-attention within WINDOW x WINDOW windows of the
    side x side token map x [N, T, C]."""
    n, _, c = x.shape
    s, m2, d = side // WINDOW, WINDOW * WINDOW, c // HEADS
    win = (x.reshape(n, s, WINDOW, s, WINDOW, c).permute(0, 1, 3, 2, 4, 5)
           .reshape(n * s * s, m2, c))
    qkv = _linear(p, f"{PRE}.qkv", win, law).reshape(-1, m2, 3, HEADS, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                # [nW, heads, M2, d]
    acc = torch.promote_types(x.dtype, torch.float32)
    bias = p[f"{PRE}.bias_table"][_relative_index(x.device)]  # [M2, M2, h]
    a = (low(q, law) @ low(k, law).transpose(-1, -2)).to(acc) / math.sqrt(d)
    a = torch.softmax(a + bias.permute(2, 0, 1).to(acc), dim=-1)
    a = a.to(trunk_dtype(law))
    o = (low(a, law) @ low(v, law)).transpose(1, 2).reshape(-1, m2, c)
    o = _linear(p, f"{PRE}.proj", o, law)
    return (o.reshape(n, s, s, WINDOW, WINDOW, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n, side * side, c))


def forward(p: dict, x_u8, train: bool, groups: int, law: str, stats: dict):
    """Features [N, WIDTH] in the trunk's dtype of uint8 images [N, H, W,
    3]; no BatchNorm, so `train`, `groups` and `stats` change nothing."""
    x = preprocess(x_u8).to(trunk_dtype(law))
    x = conv(p, f"{PRE}.patch", x, law, stride=PATCH)      # [N, C, s, s]
    side = x.shape[-1]
    x = _layer_norm(p, f"{PRE}.patch_norm", x.flatten(2).transpose(1, 2))
    h = _attention(p, _layer_norm(p, f"{PRE}.norm1", x), side, law)
    x = x + h * p[f"{PRE}.scale"].to(x.dtype)
    h = F.gelu(_linear(p, f"{PRE}.fc1", _layer_norm(p, f"{PRE}.norm2", x),
                       law))
    x = x + _linear(p, f"{PRE}.fc2", h, law)
    return _layer_norm(p, f"{PRE}.norm", x).mean(dim=1)
