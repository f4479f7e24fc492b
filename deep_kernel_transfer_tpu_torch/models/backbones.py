"""The backbone zoo with per-episode BatchNorm.

Port of deep_kernel_transfer_tpu/models/backbones.py:184-509
(`preprocess_input`, the fan-in init, `EpisodicBatchNorm`, `ConvBlock`,
the Conv4/Conv6 trunks with their no-pool "NP" and single-channel "S"
forms, `SimpleBlock`, `BottleneckBlock`, `ResNet` 10-101, the regression
trunks `Conv3` and `MLP2`, `DistLinear`, `model_dict`, `feat_dims`,
`np_feat_shapes`), which rebuilds reference backbone.py:13-402 and the
sines feature net (reference sines/train_DKT.py:113-124). The port adds a
trunk of its own that neither package had: `SwinTransformer` (Swin-T as
`SwinT`), whose activations are tokens [N, T, C] and whose windowed
attention runs in ops/window_attention.py.

Inputs keep the JAX layout, images [N, H, W, C] (uint8 or already
normalised float); inside the trunk activations are NCHW. The flattened
output is in torch's CHW order, as the reference's is (the JAX package
flattens HWC; utils/convert.py permutes between the two). The NP trunks
return maps [N, C, H, W].

Submodules carry the reference's state_dict names: `trunk.{i}.C` (conv)
and `trunk.{i}.BN` in the Conv trunks; `trunk.0` (stem conv), `trunk.1`
(its BatchNorm) and `trunk.{4+j}.{C1,BN1,C2,BN2,C3,BN3,shortcut,
BNshortcut}` in the ResNets; `trunk.{i}` (the patch embedding, each
block, each patch merging, the final norm) in SwinTransformer;
`trunk.bn_out` once methods/dkt.py adds the bncossim head; `layer{1,2,3}`
in Conv3 and `layer{1,2}` in MLP2.

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

from .._device import constant
from ..gp.kernels import full_f32
from ..ops import episodic_batchnorm as ebn
from ..ops.window_attention import window_attention
from ..utils.profiling import annotate

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
        mean = constant(IMAGENET_MEAN, torch.float32, x.device)
        std = constant(IMAGENET_STD, torch.float32, x.device)
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


class BatchStats(dict):
    """The `stats` of a train-mode forward: BatchNorm module -> (new
    running mean, new running var). `batch_sum`, where given, sums a
    tensor over the ranks that split the batch between them, with
    gradients (parallel.mesh.dp_sum): a BatchNorm over one group then
    normalises by the whole batch's statistics, as the JAX package's does
    on a batch-sharded array."""

    def __init__(self, batch_sum=None):
        super().__init__()
        self.batch_sum = batch_sum


class EpisodicBatchNorm(nn.Module):
    """BatchNorm over the channel axis (dim 1) with torch's running-average
    convention: new = (1-m) old + m batch, m = 0.1, unbiased running
    variance; eps 1e-5. With ep_groups > 1 the running update is the
    per-episode update averaged over episodes. Where `stats` is a
    BatchStats with a `batch_sum` and ep_groups is 1, the statistics are
    those of the whole batch that the ranks split between them. `relu`
    applies a ReLU to the output.

    ops/episodic_batchnorm.py::batchnorm chooses the route: the fused
    kernels there for a bf16 4-D CUDA input, outside the split-batch case
    (in eval mode where the output records no gradient), and its torch
    ops, `batchnorm_torch` (whose docstring gives the statistics' dtype
    and variance law), for every other input."""

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
                stats: dict | None = None, relu: bool = False) -> torch.Tensor:
        with annotate("batchnorm"):
            y, new = ebn.batchnorm(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, train=train, groups=ep_groups,
                batch_sum=getattr(stats, "batch_sum", None), eps=self.eps,
                momentum=self.momentum, relu=relu)
            if stats is not None and new is not None:
                stats[self] = new
            return y

    def eval_epilogue(self, x: torch.Tensor, conv_bias: torch.Tensor | None,
                      pool: bool) -> torch.Tensor:
        """Eval BatchNorm + ReLU (+ the 2x2 max-pool where `pool`) of a
        conv output x made without its bias `conv_bias`, which the same
        pass adds: the route that
        ops/episodic_batchnorm.py::takes_eval_epilogue chose for an eval
        ConvBlock."""
        with annotate("batchnorm"):
            return ebn.episodic_batchnorm_eval(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, self.eps, relu=True, conv_bias=conv_bias,
                pool=pool)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's lecun_normal in place: a normal truncated to +-2 standard
    deviations, std sqrt(1/fan_in) / .87962566103423978."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with the trunk layers' signature; the weights are cast to
    the input's dtype. `with_bias=False` leaves the bias out."""

    def forward(self, x, train=True, ep_groups=1, stats=None, with_bias=True):
        bias = (None if self.bias is None or not with_bias
                else self.bias.to(x.dtype))
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation)


class ConvBlock(nn.Module):
    """3x3 conv + BN + ReLU (+ 2x2 max-pool), reference backbone.py:105-132;
    padding 0 in the first two blocks of the NP trunks. Where
    ops/episodic_batchnorm.py::takes_eval_epilogue says so (eval, CUDA,
    bf16, no gradient), the conv runs without its bias and one kernel pass
    does the rest, the bias add included."""

    def __init__(self, in_dim: int, out_dim: int, pool: bool = True,
                 padding: int = 1):
        super().__init__()
        self.C = Conv2d(in_dim, out_dim, 3, padding=padding)
        self.BN = EpisodicBatchNorm(out_dim)
        self.pool = pool

    def forward(self, x, train=True, ep_groups=1, stats=None):
        if ebn.takes_eval_epilogue(x, self.C.out_channels, train,
                                   self.C.weight, self.C.bias, self.BN.weight,
                                   self.BN.bias):
            return self.BN.eval_epilogue(self.C(x, with_bias=False),
                                         self.C.bias, self.pool)
        x = self.BN(self.C(x), train, ep_groups, stats, relu=True)
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        return x


class Flatten(nn.Module):
    """[N, C, H, W] -> [N, C*H*W] in CHW order (reference Flatten)."""

    def forward(self, x, train=True, ep_groups=1, stats=None):
        return x.reshape(x.shape[0], -1)


class ReLU(nn.Module):
    def forward(self, x, train=True, ep_groups=1, stats=None):
        return F.relu(x)


class MaxPool(nn.Module):
    """The ResNet stem's 3x3 max-pool, stride 2, padding 1."""

    def forward(self, x, train=True, ep_groups=1, stats=None):
        return F.max_pool2d(x, 3, 2, padding=1)


class GlobalAvgPool(nn.Module):
    """Mean over H and W: [N, C, H, W] -> [N, C] (the reference's
    AvgPool2d(7) + Flatten at 224 px)."""

    def forward(self, x, train=True, ep_groups=1, stats=None):
        return x.mean(dim=(2, 3))


class Trunk(nn.Module):
    """What every trunk shares: `trunk`, a list of layers run in order
    after the input is preprocessed and moved to NCHW, and the init."""

    first_channel = False

    def reset_parameters(self, generator=None) -> None:
        """Fan-in conv init from `generator`, zero conv biases, unit BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_fanin_init_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, EpisodicBatchNorm):
                m.reset_parameters()

    def out_dim(self, height: int, width: int) -> int:
        """Width of the flat output for an image of that size."""
        return math.prod(self.out_chw(height, width))

    def forward(self, x, train=True, ep_groups=1, stats=None):
        """Preprocess NHWC images, go to NCHW, run every layer of `trunk`."""
        x = preprocess_input(x)
        if self.first_channel:
            x = x[..., :1]
        x = x.permute(0, 3, 1, 2)
        for layer in self.trunk:
            x = layer(x, train, ep_groups, stats)
        return x


class ConvNet(Trunk):
    """Conv4/Conv6 trunk (reference backbone.py:250-268): `depth` blocks of
    64 channels, max-pool in the first four. Input [N, H, W, C]; output
    [N, 64*h*w] (84x84 -> 5x5x64 = 1600).

    first_channel=True is the omniglot trunk ConvNetS (reference
    backbone.py:287-310; JAX backbones.py:220-236): only the first input
    channel goes in, 28x28 -> 1x1x64 = 64.

    nopool=True is the RelationNet trunk ConvNetNopool / ConvNetSNopool
    (JAX backbones.py:203-218, 239-253): max-pool and padding 0 in blocks
    0 and 1 only, and no flattening: maps [N, 64, h, w] (84 px -> 19x19,
    28 px -> 5x5)."""

    def __init__(self, depth: int, first_channel: bool = False,
                 nopool: bool = False):
        super().__init__()
        self.depth = depth
        self.first_channel = first_channel
        self.nopool = nopool
        in_dim = 1 if first_channel else 3
        blocks = [ConvBlock(in_dim if i == 0 else 64, 64,
                            pool=(i < 2) if nopool else (i < 4),
                            padding=0 if nopool and i < 2 else 1)
                  for i in range(depth)]
        self.trunk = nn.ModuleList(blocks + ([] if nopool else [Flatten()]))
        self.reset_parameters()

    def out_chw(self, height: int, width: int) -> tuple[int, int, int]:
        """(C, H, W) of the last block's output for an image of that size."""
        for block in self.trunk[:self.depth]:
            pad = block.C.padding[0]
            height, width = height + 2 * pad - 2, width + 2 * pad - 2
            if block.pool:
                height, width = height // 2, width // 2
        return 64, height, width


class SimpleBlock(nn.Module):
    """ResNet basic block (reference backbone.py:135-185; JAX
    backbones.py:256-291)."""

    def __init__(self, in_dim: int, out_dim: int, half_res: bool):
        super().__init__()
        stride = 2 if half_res else 1
        self.C1 = Conv2d(in_dim, out_dim, 3, stride, padding=1, bias=False)
        self.BN1 = EpisodicBatchNorm(out_dim)
        self.C2 = Conv2d(out_dim, out_dim, 3, padding=1, bias=False)
        self.BN2 = EpisodicBatchNorm(out_dim)
        if in_dim != out_dim:
            self.shortcut = Conv2d(in_dim, out_dim, 1, stride, bias=False)
            self.BNshortcut = EpisodicBatchNorm(out_dim)
        else:
            self.shortcut = None

    def forward(self, x, train=True, ep_groups=1, stats=None):
        with annotate("block"):
            h = self.BN1(self.C1(x), train, ep_groups, stats, relu=True)
            h = self.BN2(self.C2(h), train, ep_groups, stats)
            with annotate("residual"):
                s = x if self.shortcut is None else self.BNshortcut(
                    self.shortcut(x), train, ep_groups, stats)
                return F.relu(h + s)


class BottleneckBlock(nn.Module):
    """ResNet bottleneck block (reference backbone.py:190-247; JAX
    backbones.py:293-334). Two quirks of the reference are kept: the 3x3
    conv keeps its bias, and the 1x1 shortcut has no BatchNorm."""

    def __init__(self, in_dim: int, out_dim: int, half_res: bool):
        super().__init__()
        mid = out_dim // 4
        stride = 2 if half_res else 1
        self.C1 = Conv2d(in_dim, mid, 1, bias=False)
        self.BN1 = EpisodicBatchNorm(mid)
        self.C2 = Conv2d(mid, mid, 3, stride, padding=1)
        self.BN2 = EpisodicBatchNorm(mid)
        self.C3 = Conv2d(mid, out_dim, 1, bias=False)
        self.BN3 = EpisodicBatchNorm(out_dim)
        self.shortcut = (Conv2d(in_dim, out_dim, 1, stride, bias=False)
                         if in_dim != out_dim else None)

    def forward(self, x, train=True, ep_groups=1, stats=None):
        with annotate("block"):
            h = self.BN1(self.C1(x), train, ep_groups, stats, relu=True)
            h = self.BN2(self.C2(h), train, ep_groups, stats, relu=True)
            h = self.BN3(self.C3(h), train, ep_groups, stats)
            with annotate("residual"):
                s = x if self.shortcut is None else self.shortcut(x)
                return F.relu(h + s)


class ResNet(Trunk):
    """ResNet trunk for 224x224 inputs (reference backbone.py:330-376; JAX
    backbones.py:336-364): the 7x7/2 stem conv, BN, ReLU and a 3x3/2
    max-pool with padding 1 (trunk.0-3), then the blocks (trunk.4 on),
    `half_res` on the first block of stages 2-4, and with `flatten` the
    mean over the final map (224 px -> 7x7 -> [N, C])."""

    def __init__(self, block, num_layers, out_dims, flatten: bool = True):
        super().__init__()
        self.num_layers = tuple(num_layers)
        self.out_dims = tuple(out_dims)
        self.flatten = flatten
        layers = [Conv2d(3, 64, 7, 2, padding=3, bias=False),
                  EpisodicBatchNorm(64), ReLU(), MaxPool()]
        in_dim = 64
        for i, (n, out_dim) in enumerate(zip(num_layers, out_dims)):
            for j in range(n):
                layers.append(block(in_dim, out_dim, i >= 1 and j == 0))
                in_dim = out_dim
        if flatten:
            layers.append(GlobalAvgPool())
        self.trunk = nn.ModuleList(layers)
        self.reset_parameters()

    def out_chw(self, height: int, width: int) -> tuple[int, int, int]:
        """(C, H, W) of the last block's map for an image of that size;
        the flat output (with `flatten`) is its C channel means."""
        def half(s):
            return (s - 1) // 2 + 1

        height, width = half(half(height)), half(half(width))  # stem, pool
        for _ in self.out_dims[1:]:
            height, width = half(height), half(width)
        return self.out_dims[-1], height, width

    def out_dim(self, height: int, width: int) -> int:
        c, h, w = self.out_chw(height, width)
        return c if self.flatten else c * h * w


class Linear(nn.Linear):
    """nn.Linear over the last dim; the weights are cast to the input's
    dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last dim, eps 1e-5; the weights are cast to
    the input's dtype (ATen takes a bf16 input's statistics in f32)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class PatchEmbed(nn.Module):
    """Swin's patch embedding: a patch x patch convolution of stride patch
    to `dim` channels, then LayerNorm over the tokens [N, h w, dim] in
    row-major order of the h x w map."""

    def __init__(self, dim: int, patch: int, resolution: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)
        self.norm = LayerNorm(dim)
        self.resolution = resolution

    def forward(self, x, train=True, ep_groups=1, stats=None):
        x = self.proj(x)
        if x.shape[-2:] != (self.resolution, self.resolution):
            raise ValueError(f"the trunk was built for a {self.resolution} x "
                             f"{self.resolution} token map; the images give "
                             f"{tuple(x.shape[-2:])}")
        return self.norm(x.flatten(2).transpose(1, 2))


class WindowAttention(nn.Module):
    """Multi-head self-attention within window x window windows of the
    resolution x resolution map cyclically shifted by `shift`, with a
    learned relative-position bias table (Swin's `attn`): the qkv product,
    ops/window_attention.py (the kernels on the card), the output
    projection."""

    def __init__(self, dim: int, heads: int, resolution: int, window: int,
                 shift: int):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.resolution = resolution
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))

    def forward(self, x):
        o = window_attention(
            self.qkv(x), self.relative_position_bias_table, self.heads,
            self.window, self.shift, (self.resolution, self.resolution))
        return self.proj(o)


class Mlp(nn.Module):
    """Linear to `hidden`, exact GELU, Linear back."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """A Swin Transformer block on tokens [N, T, C]: x + attn(norm1(x)),
    then x + mlp(norm2(x)); no BatchNorm, so `train`, `ep_groups` and
    `stats` change nothing."""

    def __init__(self, dim: int, heads: int, resolution: int, window: int,
                 shift: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, resolution, window, shift)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x, train=True, ep_groups=1, stats=None):
        with annotate("block"):
            with annotate("attention"):
                h = self.attn(self.norm1(x))
            x = x + h
            return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """Swin's patch merging: each 2x2 neighbourhood's tokens concatenated
    (rows 0::2 and 1::2 of column 0::2, then of column 1::2), LayerNorm over
    the 4C channels, a linear map to 2C without bias."""

    def __init__(self, dim: int, resolution: int):
        super().__init__()
        self.resolution = resolution
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, train=True, ep_groups=1, stats=None):
        with annotate("merge"):
            n, _, c = x.shape
            x = x.view(n, self.resolution, self.resolution, c)
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
            return self.reduction(self.norm(x.view(n, -1, 4 * c)))


class TokenMean(nn.Module):
    """The final LayerNorm, then the mean over the tokens: [N, T, C] ->
    [N, C]."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, x, train=True, ep_groups=1, stats=None):
        return self.norm(x).mean(dim=1)


class SwinTransformer(Trunk):
    """Swin Transformer (Liu et al., arXiv:2103.14030) for img_size x
    img_size inputs: a patch x patch embedding to `dim` channels (trunk.0),
    then for each stage `depth` blocks with `heads` heads of width dim /
    heads in window x window windows, every second block's windows shifted
    by window // 2 (a stage whose map is no larger than a window takes one
    unshifted window of the whole map), and a patch merging between
    stages that halves the map and doubles the width; last the final
    LayerNorm and the mean over the tokens (trunk.{last}, D = the last
    width). The trunk's list runs these in order: trunk.{i} is the
    embedding, a block, a merging or the final norm. Stochastic depth and
    dropout are left out (rate 0). Parameters carry Swin's names within a
    layer (norm1, attn.qkv, attn.proj, attn.relative_position_bias_table,
    norm2, mlp.fc1, mlp.fc2; norm, reduction); the init is the benchmark
    configuration's weight laws: the embedding's convolution N(0, 2 / (k k
    out)), linear weights and the bias tables N(0, 0.02^2), zero biases,
    unit LayerNorms."""

    def __init__(self, img_size: int = 224, patch: int = 4, dim: int = 96,
                 depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window: int = 7,
                 mlp_ratio: int = 4):
        super().__init__()
        res = img_size // patch
        layers = [PatchEmbed(dim, patch, res)]
        for i, (depth, nh) in enumerate(zip(depths, heads)):
            m = min(window, res)
            shift = 0 if res <= window else window // 2
            for j in range(depth):
                layers.append(SwinBlock(dim, nh, res, m, shift if j % 2 else 0,
                                        mlp_ratio))
            if i < len(depths) - 1:
                layers.append(PatchMerging(dim, res))
                res, dim = res // 2, 2 * dim
        layers.append(TokenMean(dim))
        self.trunk = nn.ModuleList(layers)
        self.dim = dim
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters(generator)
        device = None if generator is None else generator.device
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    m.weight.copy_(0.02 * torch.randn(
                        m.weight.shape, generator=generator, device=device))
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                elif isinstance(m, WindowAttention):
                    t = m.relative_position_bias_table
                    t.copy_(0.02 * torch.randn(t.shape, generator=generator,
                                               device=device))

    def out_dim(self, height: int, width: int) -> int:
        return self.dim


class DistLinear(nn.Module):
    """Weight-normalised cosine classifier head of Baseline++ (reference
    backbone.py:22-44; JAX backbones.py:403-429): scores = s·cos(x, w_c),
    w_c = v_c/(|v_c| + 1e-5)·g_c, x/(|x| + 1e-5), s = 2 for at most 200
    classes, else 10. The parameters are the reference's WeightNorm names,
    `L.weight_v` [out, in] and `L.weight_g` [out, 1]."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.L = nn.Module()
        self.L.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))
        self.L.weight_g = nn.Parameter(torch.ones(out_dim, 1))
        self.scale_factor = 2.0 if out_dim <= 200 else 10.0
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.L.weight_v, self.L.weight_v.shape[1], generator)
        with torch.no_grad():
            self.L.weight_g.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_n = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-5)
        v = self.L.weight_v
        w = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-5) \
            * self.L.weight_g
        return self.scale_factor * (x_n @ w.T)


def Conv4() -> ConvNet:
    return ConvNet(depth=4)


def Conv6() -> ConvNet:
    return ConvNet(depth=6)


def Conv4S() -> ConvNet:
    return ConvNet(depth=4, first_channel=True)


def Conv4NP() -> ConvNet:
    return ConvNet(depth=4, nopool=True)


def Conv6NP() -> ConvNet:
    return ConvNet(depth=6, nopool=True)


def Conv4SNP() -> ConvNet:
    return ConvNet(depth=4, first_channel=True, nopool=True)


def ResNet10(flatten: bool = True) -> ResNet:
    return ResNet(SimpleBlock, [1, 1, 1, 1], [64, 128, 256, 512], flatten)


def ResNet18(flatten: bool = True) -> ResNet:
    return ResNet(SimpleBlock, [2, 2, 2, 2], [64, 128, 256, 512], flatten)


def ResNet34(flatten: bool = True) -> ResNet:
    return ResNet(SimpleBlock, [3, 4, 6, 3], [64, 128, 256, 512], flatten)


def ResNet50(flatten: bool = True) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 6, 3], [256, 512, 1024, 2048],
                  flatten)


def ResNet101(flatten: bool = True) -> ResNet:
    return ResNet(BottleneckBlock, [3, 4, 23, 3], [256, 512, 1024, 2048],
                  flatten)


def SwinT() -> SwinTransformer:
    """Swin-T (arXiv:2103.14030, Table 1): C = 96, blocks (2, 2, 6, 2),
    heads (3, 6, 12, 24), 7x7 windows, 224 px."""
    return SwinTransformer()


class Conv3(nn.Module):
    """The QMUL regression trunk (reference backbone.py:379-402; JAX
    backbones.py:366-387): three 3x3 convs of 36 channels, dilation 2,
    stride 2, no padding, each followed by ReLU, no BatchNorm; 100 px ->
    9x9x36 = 2916 features, flattened in CHW order. uint8 images are
    scaled by 1/255 only (QMUL has no ImageNet normalisation, reference
    data/qmul_loader.py)."""

    input_rank = 3  # an input is [H, W, C]

    def __init__(self):
        super().__init__()
        self.layer1 = Conv2d(3, 36, 3, stride=2, dilation=2)
        self.layer2 = Conv2d(36, 36, 3, stride=2, dilation=2)
        self.layer3 = Conv2d(36, 36, 3, stride=2, dilation=2)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """Fan-in conv weights from `generator`, zero biases (JAX
        backbones.py:63-70)."""
        for conv in (self.layer1, self.layer2, self.layer3):
            conv_fanin_init_(conv.weight, generator)
            nn.init.zeros_(conv.bias)

    def out_chw(self, height: int, width: int) -> tuple[int, int, int]:
        for _ in range(3):  # receptive field 5, stride 2
            height, width = (height - 5) // 2 + 1, (width - 5) // 2 + 1
        return 36, height, width

    def out_dim(self, height: int, width: int) -> int:
        return math.prod(self.out_chw(height, width))

    def forward(self, x, train=True, ep_groups=1, stats=None):
        x = preprocess_input(x, imagenet=False).permute(0, 3, 1, 2)
        for conv in (self.layer1, self.layer2, self.layer3):
            x = F.relu(conv(x))
        return x.reshape(x.shape[0], -1)


class MLP2(nn.Module):
    """The sines feature net: Linear(1, 40) + ReLU, Linear(40, 40) + ReLU
    (reference sines/train_DKT.py:113-124; JAX backbones.py:390-400), with
    flax's lecun_normal weights and zero biases. Input [N, 1]."""

    input_rank = 1  # an input is [1]

    def __init__(self, width: int = 40):
        super().__init__()
        self.width = width
        self.layer1 = nn.Linear(1, width)
        self.layer2 = nn.Linear(width, width)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.layer1, self.layer2):
            lecun_normal_(layer.weight, layer.weight.shape[1], generator)
            nn.init.zeros_(layer.bias)

    def out_dim(self, *size) -> int:
        return self.width

    def forward(self, x, train=True, ep_groups=1, stats=None):
        return F.relu(self.layer2(F.relu(self.layer1(x))))


def trunk_features(trunk: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A regression trunk over inputs [..., N, *input] (`trunk.input_rank`
    trailing axes an input), run once over the flat batch with TF32 off:
    features [..., N, D]."""
    lead = x.shape[:x.dim() - trunk.input_rank]
    with full_f32():
        z = trunk(x.reshape((-1,) + tuple(x.shape[len(lead):])))
    return z.reshape(tuple(lead) + tuple(z.shape[1:]))


model_dict = dict(Conv4=Conv4, Conv4S=Conv4S, Conv6=Conv6,
                  ResNet10=ResNet10, ResNet18=ResNet18, ResNet34=ResNet34,
                  ResNet50=ResNet50, ResNet101=ResNet101, SwinT=SwinT,
                  Conv3=Conv3, MLP2=MLP2)

# width of the flat features (reference backbone.py:264,304,368; SwinT
# the port's own)
feat_dims = {"Conv4": 1600, "Conv4S": 64, "Conv6": 1600, "ResNet10": 512,
             "ResNet18": 512, "ResNet34": 512, "ResNet50": 2048,
             "ResNet101": 2048, "SwinT": 768, "Conv3": 2916, "MLP2": 40}

# the NP trunks' maps, (C, H, W) in the port's NCHW layout (the JAX
# package's np_feat_shapes hold the same maps as (H, W, C))
np_feat_shapes = {"Conv4NP": (64, 19, 19), "Conv6NP": (64, 19, 19),
                  "Conv4SNP": (64, 5, 5)}
