"""Conv4 and Conv4S trunks with per-episode BatchNorm.

Port of deep_kernel_transfer_tpu/models/backbones.py (`preprocess_input`,
the fan-in init, `EpisodicBatchNorm`, `ConvBlock`, `ConvNet`, `ConvNetS`,
`Conv4`, `Conv4S`, `model_dict`), which rebuilds reference
backbone.py:105-132, 250-310.

Inputs keep the JAX layout, images [N, H, W, C] (uint8 or already
normalised float); inside the trunk activations are NCHW. The flattened
output is in torch's CHW order, as the reference's is (the JAX package
flattens HWC; utils/convert.py permutes between the two).

Submodules carry the reference's state_dict names: `trunk.{i}.C` (conv),
`trunk.{i}.BN` (BatchNorm), and `trunk.bn_out` once methods/dkt.py adds
the bncossim head.

Every layer takes (x, train, ep_groups, stats):
  * train=True normalises by batch statistics and, when `stats` is a dict,
    records the new running averages there (stats[bn] = (mean, var));
    nothing is written to the buffers until methods.base.merge_stats.
    train=False normalises by the running averages.
  * ep_groups > 1 (train mode): the batch is that many episodes laid out
    contiguously, and statistics are per episode.
  * Weights are cast to the input's dtype, so a bf16 input runs the layer
    in bf16 from float32 master weights (methods.base.apply_trunk).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# ImageNet statistics (reference data/datamgr.py:15)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_input(x: torch.Tensor, imagenet: bool = True) -> torch.Tensor:
    """uint8 images [..., C] -> float32 /255, ImageNet-normalised; float
    inputs pass through untouched (taken as already normalised)."""
    if x.is_floating_point():
        return x
    x = x.to(torch.float32) / 255.0
    if imagenet:
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = (x - mean) / std
    return x


def conv_fanin_init_(weight: torch.Tensor, generator=None) -> None:
    """Normal(0, sqrt(2/n)) with n = kh*kw*out_channels, in place
    (reference backbone.py:13-17)."""
    out, _, kh, kw = weight.shape
    device = weight.device if generator is None else generator.device
    draw = torch.randn(weight.shape, generator=generator, device=device)
    with torch.no_grad():
        weight.copy_(draw * math.sqrt(2.0 / (kh * kw * out)))


class EpisodicBatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) with torch's running-average
    convention: new = (1-m) old + m batch, m = 0.1, unbiased running
    variance; eps 1e-5. Statistics are float32 whatever the input dtype.
    With ep_groups > 1 the running update is the per-episode update
    averaged over episodes. A float32 input takes the two-pass variance,
    a lower-precision one the one-pass E[x^2] - m^2 (JAX backbones.py
    :125-139)."""

    momentum = 0.1
    eps = 1e-5

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = True, ep_groups: int = 1,
                stats: dict | None = None) -> torch.Tensor:
        c = x.shape[1]
        xf = x.to(torch.float32)
        spatial = (1,) * (x.dim() - 2)
        if not train:
            mean = self.running_mean.view(1, c, *spatial)
            var = self.running_var.view(1, c, *spatial)
            y = (xf - mean) * torch.rsqrt(var + self.eps)
        else:
            if x.shape[0] % ep_groups:
                raise ValueError(f"batch {x.shape[0]} is not a multiple of "
                                 f"ep_groups={ep_groups}")
            xg = xf.reshape(ep_groups, x.shape[0] // ep_groups, *x.shape[1:])
            axes = (1,) + tuple(range(3, xg.dim()))  # all but group, channel
            bshape = (ep_groups, 1, c) + spatial
            mean = xg.mean(dim=axes)  # [G, C]
            if x.dtype == torch.float32:
                var = torch.square(xg - mean.view(bshape)).mean(dim=axes)
            else:
                ex2 = torch.square(xg).mean(dim=axes)
                var = torch.clamp(ex2 - torch.square(mean), min=0.0)
            if stats is not None:
                n = xg[0].numel() / c
                unbiased = var.detach() * (n / max(n - 1.0, 1.0))
                m = self.momentum
                stats[self] = (
                    (1.0 - m) * self.running_mean + m * mean.detach().mean(0),
                    (1.0 - m) * self.running_var + m * unbiased.mean(0))
            y = (xg - mean.view(bshape)) * torch.rsqrt(var.view(bshape)
                                                       + self.eps)
            y = y.reshape(xf.shape)
        w = self.weight.to(x.dtype).to(torch.float32).view(1, c, *spatial)
        b = self.bias.to(x.dtype).to(torch.float32).view(1, c, *spatial)
        return (y * w + b).to(x.dtype)


class ConvBlock(nn.Module):
    """3x3 conv + BN + ReLU (+ 2x2 max-pool), reference backbone.py:105-132."""

    def __init__(self, in_dim: int, out_dim: int, pool: bool = True):
        super().__init__()
        self.C = nn.Conv2d(in_dim, out_dim, 3, padding=1)
        self.BN = EpisodicBatchNorm(out_dim)
        self.pool = pool

    def forward(self, x, train=True, ep_groups=1, stats=None):
        x = F.conv2d(x, self.C.weight.to(x.dtype), self.C.bias.to(x.dtype),
                     padding=self.C.padding)
        x = F.relu(self.BN(x, train, ep_groups, stats))
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        return x


class Flatten(nn.Module):
    """[N, C, H, W] -> [N, C*H*W] in CHW order (reference Flatten)."""

    def forward(self, x, train=True, ep_groups=1, stats=None):
        return x.reshape(x.shape[0], -1)


class ConvNet(nn.Module):
    """Conv4/Conv6 trunk (reference backbone.py:250-268): `depth` blocks of
    64 channels, max-pool in the first four. Input [N, H, W, C]; output
    [N, 64*h*w] (84x84 -> 5x5x64 = 1600).

    first_channel=True is the omniglot trunk ConvNetS (reference
    backbone.py:287-310; JAX backbones.py:220-236): only the first input
    channel goes in, 28x28 -> 1x1x64 = 64."""

    def __init__(self, depth: int, first_channel: bool = False):
        super().__init__()
        self.depth = depth
        self.first_channel = first_channel
        in_dim = 1 if first_channel else 3
        blocks = [ConvBlock(in_dim if i == 0 else 64, 64, pool=(i < 4))
                  for i in range(depth)]
        self.trunk = nn.ModuleList(blocks + [Flatten()])
        self.reset_parameters()

    def out_chw(self, height: int, width: int) -> tuple[int, int, int]:
        """(C, H, W) of the last block's output for an image of that size."""
        for i in range(self.depth):
            if i < 4:
                height, width = height // 2, width // 2
        return 64, height, width

    def out_dim(self, height: int, width: int) -> int:
        return math.prod(self.out_chw(height, width))

    def reset_parameters(self, generator=None) -> None:
        """Fan-in conv init from `generator`, zero biases, unit BN."""
        for m in self.modules():
            if isinstance(m, ConvBlock):
                conv_fanin_init_(m.C.weight, generator)
                nn.init.zeros_(m.C.bias)
            elif isinstance(m, EpisodicBatchNorm):
                m.reset_parameters()

    def forward(self, x, train=True, ep_groups=1, stats=None):
        """Preprocess NHWC images, go to NCHW, run every layer of `trunk`."""
        x = preprocess_input(x)
        if self.first_channel:
            x = x[..., :1]
        x = x.permute(0, 3, 1, 2)
        for layer in self.trunk:
            x = layer(x, train, ep_groups, stats)
        return x


def Conv4() -> ConvNet:
    return ConvNet(depth=4)


def Conv4S() -> ConvNet:
    return ConvNet(depth=4, first_channel=True)


class _ModelDict(dict):
    """The CLI's `--model` names (JAX backbones.py:476); a name of the JAX
    zoo not ported yet raises."""

    def __missing__(self, name):
        raise NotImplementedError(
            f"backbone '{name}' is not ported yet (ROADMAP queue A, item 6)")


model_dict = _ModelDict(Conv4=Conv4, Conv4S=Conv4S)
