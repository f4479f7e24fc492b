"""ResNet10 (reference backbone.py ResNet(SimpleBlock, [1, 1, 1, 1])): a
7x7/2 convolution with 64 channels, BatchNorm, ReLU and a 3x3/2 max-pool,
then one basic block at each of 64, 128, 256 and 512 channels (stride 2
and a 1x1 shortcut with BatchNorm where the width changes), then the mean
over the map (224 px -> 7 x 7 -> 512)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import batchnorm, conv, preprocess, trunk_dtype

STAGES = (64, 128, 256, 512)


def _half(s: int) -> int:
    return (s - 1) // 2 + 1


def _blocks():
    """(trunk index, in channels, out channels, stride) of each block."""
    cin = 64
    for j, cout in enumerate(STAGES):
        yield 4 + j, cin, cout, 2 if j else 1
        cin = cout


def conv_shapes(size: int) -> list[tuple[int, int, int, int, int]]:
    s = _half(size)
    out = [(3, 64, 7, s, s)]
    s = _half(s)
    for _, cin, cout, stride in _blocks():
        if stride == 2:
            s = _half(s)
        out.append((cin, cout, 3, s, s))
        out.append((cout, cout, 3, s, s))
        if cin != cout:
            out.append((cin, cout, 1, s, s))
    return out


def feat_dim(size: int) -> int:
    return STAGES[-1]


def _bn(shapes, name, c):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        shapes[f"{name}.{leaf}"] = ((c,), "bn_" + leaf)


def param_shapes(size: int) -> dict:
    shapes = {"feature.trunk.0.weight": ((64, 3, 7, 7), "conv")}
    _bn(shapes, "feature.trunk.1", 64)
    for i, cin, cout, _ in _blocks():
        pre = f"feature.trunk.{i}"
        shapes[f"{pre}.C1.weight"] = ((cout, cin, 3, 3), "conv")
        _bn(shapes, f"{pre}.BN1", cout)
        shapes[f"{pre}.C2.weight"] = ((cout, cout, 3, 3), "conv")
        _bn(shapes, f"{pre}.BN2", cout)
        if cin != cout:
            shapes[f"{pre}.shortcut.weight"] = ((cout, cin, 1, 1), "conv")
            _bn(shapes, f"{pre}.BNshortcut", cout)
    return shapes


def forward(p: dict, x_u8, train: bool, groups: int, law: str, stats: dict):
    """bfloat16 features [N, 512] of uint8 images [N, H, W, 3] (float64
    under that law)."""
    x = preprocess(x_u8).to(trunk_dtype(law))
    x = conv(p, "feature.trunk.0", x, law, stride=2, padding=3)
    x = F.relu(batchnorm(p, "feature.trunk.1", x, train, groups, stats, law))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for i, cin, cout, stride in _blocks():
        pre = f"feature.trunk.{i}"
        h = conv(p, f"{pre}.C1", x, law, stride=stride, padding=1)
        h = F.relu(batchnorm(p, f"{pre}.BN1", h, train, groups, stats, law))
        h = batchnorm(p, f"{pre}.BN2", conv(p, f"{pre}.C2", h, law, padding=1),
                      train, groups, stats, law)
        if cin != cout:
            x = batchnorm(p, f"{pre}.BNshortcut",
                          conv(p, f"{pre}.shortcut", x, law, stride=stride),
                          train, groups, stats, law)
        x = F.relu(h + x)
    return x.mean(dim=(2, 3))
