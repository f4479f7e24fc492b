"""ResNet50 (He et al., arXiv:1512.03385, Table 1, the 50-layer column; the
reference's backbone.py ResNet(BottleneckBlock, [3, 4, 6, 3], [256, 512,
1024, 2048]), its --model=ResNet50): a 7x7/2 convolution with 64
channels, BatchNorm, ReLU and a 3x3/2 max-pool, then 3, 4, 6 and 3
bottleneck blocks at 256, 512, 1024 and 2048 channels, then the mean over
the map (224 px -> 7 x 7 -> 2048).

A bottleneck block: a 1x1 convolution to a quarter of the block's width,
BatchNorm, ReLU; a 3x3 convolution, BatchNorm, ReLU; a 1x1 convolution to
the block's width, BatchNorm; then the shortcut (the input itself, or a
1x1 convolution where the width changes) is added and a ReLU taken. The
first block of stages 2-4 halves the map. 53 convolutions, 49 BatchNorms.

Departures from the published network, which the reference code makes
and the program keeps:
  * the 3x3 convolution keeps its bias (zero at the initial law; under a
    training-mode BatchNorm its gradient is nought);
  * the four 1x1 projection shortcuts have no BatchNorm;
  * the stride sits on the 3x3 convolution (and on the shortcut), not on
    the first 1x1 convolution.

Under grad each bottleneck block runs through torch.utils.checkpoint
(use_reentrant=False): its activations are recomputed in the backward
instead of kept, so that three bfloat16 steps at 840 images and the
float64 gradient fit on one card. The recompute runs the same operations
in the same order, so values and gradients are a plain forward's; it
writes the block's running averages into `stats` again, with the same
values.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import batchnorm, conv, preprocess, trunk_dtype

STAGES = ((3, 256), (4, 512), (6, 1024), (3, 2048))  # (blocks, width)
EXPANSION = 4


def _half(s: int) -> int:
    return (s - 1) // 2 + 1


def _blocks():
    """(trunk index, in channels, out channels, stride) of each block."""
    i, cin = 4, 64
    for j, (n, cout) in enumerate(STAGES):
        for b in range(n):
            yield i, cin, cout, 2 if j and not b else 1
            i, cin = i + 1, cout


def _maps(size: int):
    """(block, map side at its input, map side at its output) of each
    block."""
    s = _half(_half(size))
    for blk in _blocks():
        out = _half(s) if blk[3] == 2 else s
        yield blk, s, out
        s = out


def conv_shapes(size: int) -> list[tuple[int, int, int, int, int]]:
    """(in channels, out channels, kernel, out height, out width) of each
    convolution, in order: the stem, then each block's C1, C2, C3 and
    projection shortcut."""
    out = [(3, 64, 7, _half(size), _half(size))]
    for (_, cin, cout, _), s, so in _maps(size):
        mid = cout // EXPANSION
        out += [(cin, mid, 1, s, s), (mid, mid, 3, so, so),
                (mid, cout, 1, so, so)]
        if cin != cout:
            out.append((cin, cout, 1, so, so))
    return out


def bn_shapes(size: int) -> list[tuple[int, int, int]]:
    """(channels, height, width) of each trunk BatchNorm, in order: the
    stem's, then each block's BN1, BN2 and BN3."""
    out = [(64, _half(size), _half(size))]
    for (_, _, cout, _), s, so in _maps(size):
        mid = cout // EXPANSION
        out += [(mid, s, s), (mid, so, so), (cout, so, so)]
    return out


def feat_dim(size: int) -> int:
    return STAGES[-1][1]


def _bn(shapes, name, c):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"{name}.{leaf}"] = ((c,), "bn_" + leaf)


def param_shapes(size: int) -> dict:
    """name -> (shape, kind), in the program's state_dict names."""
    shapes = {"feature.trunk.0.weight": ((64, 3, 7, 7), "conv")}
    _bn(shapes, "feature.trunk.1", 64)
    for i, cin, cout, _ in _blocks():
        pre, mid = f"feature.trunk.{i}", cout // EXPANSION
        shapes[f"{pre}.C1.weight"] = ((mid, cin, 1, 1), "conv")
        _bn(shapes, f"{pre}.BN1", mid)
        shapes[f"{pre}.C2.weight"] = ((mid, mid, 3, 3), "conv")
        shapes[f"{pre}.C2.bias"] = ((mid,), "conv_bias")
        _bn(shapes, f"{pre}.BN2", mid)
        shapes[f"{pre}.C3.weight"] = ((cout, mid, 1, 1), "conv")
        _bn(shapes, f"{pre}.BN3", cout)
        if cin != cout:
            shapes[f"{pre}.shortcut.weight"] = ((cout, cin, 1, 1), "conv")
    return shapes


def _block(p, i, cin, cout, stride, train, groups, law, stats, x):
    pre = f"feature.trunk.{i}"
    h = conv(p, f"{pre}.C1", x, law)
    h = F.relu(batchnorm(p, f"{pre}.BN1", h, train, groups, stats, law))
    h = conv(p, f"{pre}.C2", h, law, stride=stride, padding=1)
    h = F.relu(batchnorm(p, f"{pre}.BN2", h, train, groups, stats, law))
    h = batchnorm(p, f"{pre}.BN3", conv(p, f"{pre}.C3", h, law), train,
                  groups, stats, law)
    if cin != cout:
        x = conv(p, f"{pre}.shortcut", x, law, stride=stride)
    return F.relu(h + x)


def forward(p: dict, x_u8, train: bool, groups: int, law: str, stats: dict):
    """bfloat16 features [N, 2048] of uint8 images [N, H, W, 3] (float64
    under that law); each block recomputed in the backward under grad."""
    x = preprocess(x_u8).to(trunk_dtype(law))
    x = conv(p, "feature.trunk.0", x, law, stride=2, padding=3)
    x = F.relu(batchnorm(p, "feature.trunk.1", x, train, groups, stats, law))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for blk in _blocks():
        block = functools.partial(_block, p, *blk, train, groups, law, stats)
        x = (checkpoint(block, x, use_reentrant=False)
             if torch.is_grad_enabled() else block(x))
    return x.mean(dim=(2, 3))
