"""Conv4 (reference backbone.py ConvNet(4)): four blocks of a 3x3
convolution with 64 channels and a bias, BatchNorm, ReLU and a 2x2
max-pool; the map flattened in CHW order (84 px -> 64 x 5 x 5 = 1600)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import batchnorm, conv, preprocess, trunk_dtype

DEPTH = 4
WIDTH = 64


def conv_shapes(size: int) -> list[tuple[int, int, int, int, int]]:
    """(in channels, out channels, kernel, out height, out width) of each
    convolution, in order."""
    out, cin = [], 3
    for _ in range(DEPTH):
        out.append((cin, WIDTH, 3, size, size))
        cin, size = WIDTH, size // 2
    return out


def feat_dim(size: int) -> int:
    for _ in range(DEPTH):
        size //= 2
    return WIDTH * size * size


def param_shapes(size: int) -> dict:
    """name -> (shape, kind), in the program's state_dict names."""
    shapes = {}
    for i, (cin, cout, k, _, _) in enumerate(conv_shapes(size)):
        pre = f"feature.trunk.{i}"
        shapes[f"{pre}.C.weight"] = ((cout, cin, k, k), "conv")
        shapes[f"{pre}.C.bias"] = ((cout,), "conv_bias")
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{pre}.BN.{leaf}"] = ((cout,), "bn_" + leaf)
    return shapes


def forward(p: dict, x_u8, train: bool, groups: int, law: str, stats: dict):
    """Flat bfloat16 features [N, 1600] of uint8 images [N, H, W, 3]
    (float64 under that law)."""
    x = preprocess(x_u8).to(trunk_dtype(law))
    for i in range(DEPTH):
        pre = f"feature.trunk.{i}"
        x = conv(p, f"{pre}.C", x, law, padding=1)
        x = F.relu(batchnorm(p, f"{pre}.BN", x, train, groups, stats,
                             law))
        x = F.max_pool2d(x, 2, 2)
    return x.reshape(x.shape[0], -1)
