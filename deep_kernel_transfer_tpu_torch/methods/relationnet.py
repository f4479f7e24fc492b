"""RelationNet: a learned relation scorer over pairs of unpooled feature
maps.

Port of deep_kernel_transfer_tpu/methods/relationnet.py:26-224 (reference
methods/relationnet.py): the NP trunks keep their maps ([N, C, H, W]
here); prototypes are the support means; each (query, prototype) pair is
concatenated on the channel axis, prototype first, and scored by a small
conv module (RelationModule, reference relationnet.py:128-154). Losses:
mse on one-hot (relationnet) or cross-entropy (relationnet_softmax). The
trunk runs in bf16; the relation module and the losses stay f32.

Test-time adaptation (`adapted_scores_from_features`, reference
relationnet.py:42-93) finetunes a copy of the relation module per episode
for 100 epochs of torch's SGD on random 3/2 sub-splits of the support,
BatchNorm frozen in eval mode. The episodes of a batch finetune together:
each holds its own copy of the module's weights along a leading axis, and
torch.func vmaps one episode's gradient over them.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.backbones import EpisodicBatchNorm, lecun_normal_
from .base import (EpisodicMethod, episode_cross_entropy, episode_labels,
                   torch_sgd_step)

ADAPT_EPOCHS = 100


def relation_module_geometry(h: int, w: int) -> tuple[int, int, int]:
    """(hs, ws, padding) of the relation module's last map for input maps
    h x w (JAX relationnet.py:42-60): padding 1 on maps under 10x10, then
    per block a 3x3 conv and a 2x2 max-pool that is skipped when either
    dimension after the conv is below 2."""
    padding = 1 if (h < 10 and w < 10) else 0

    def block(hh: int, ww: int) -> tuple[int, int]:
        hh, ww = hh - 2 + 2 * padding, ww - 2 + 2 * padding
        if hh >= 2 and ww >= 2:
            hh, ww = hh // 2, ww // 2
        return hh, ww

    hs, ws = block(*block(h, w))
    return hs, ws, padding


class RelationConvBlock(nn.Module):
    """conv3x3 + BN + ReLU + 2x2 max-pool (reference relationnet.py:
    107-126); the pool is skipped on maps below 2x2."""

    def __init__(self, in_dim: int, out_dim: int, padding: int):
        super().__init__()
        self.C = nn.Conv2d(in_dim, out_dim, 3, padding=padding)
        self.BN = EpisodicBatchNorm(out_dim)

    def forward(self, x, train=True, ep_groups=1, stats=None):
        x = self.BN(self.C(x), train, ep_groups, stats, relu=True)
        if x.shape[-2] >= 2 and x.shape[-1] >= 2:
            x = F.max_pool2d(x, 2, 2)
        return x


class RelationModule(nn.Module):
    """Two conv blocks and two dense layers -> one relation score per pair
    [P, 2C, h, w] -> [P, 1] (reference relationnet.py:128-154); sigmoid
    for the mse loss."""

    def __init__(self, feat_shape, hidden_size: int = 8,
                 loss_type: str = "mse"):
        super().__init__()
        c, h, w = feat_shape
        hs, ws, padding = relation_module_geometry(h, w)
        self.layer1 = RelationConvBlock(2 * c, c, padding)
        self.layer2 = RelationConvBlock(c, c, padding)
        self.fc1 = nn.Linear(c * hs * ws, hidden_size)
        self.fc2 = nn.Linear(hidden_size, 1)
        self.loss_type = loss_type

    def reset_parameters(self, generator=None) -> None:
        """flax's defaults: lecun_normal kernels, zero biases, unit BN."""
        for m in (self.layer1.C, self.layer2.C, self.fc1, self.fc2):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
        self.layer1.BN.reset_parameters()
        self.layer2.BN.reset_parameters()

    def forward(self, x, train=True, ep_groups=1, stats=None):
        x = self.layer1(x, train, ep_groups, stats)
        x = self.layer2(x, train, ep_groups, stats)
        x = self.fc2(F.relu(self.fc1(x.reshape(x.shape[0], -1))))
        return torch.sigmoid(x) if self.loss_type == "mse" else x


class RelationNet(EpisodicMethod):
    def __init__(self, backbone: nn.Module, feat_shape, n_way: int,
                 n_support: int, loss_type: str = "mse", lr: float = 1e-3,
                 feature_dtype: str = "bfloat16", device=None):
        """feat_shape: (C, H, W) of the trunk's maps."""
        super().__init__(n_way, n_support, lr, feature_dtype, device)
        self.feature = backbone
        self.feat_shape = tuple(feat_shape)
        self.loss_type = loss_type
        self.relation_module = RelationModule(self.feat_shape, 8, loss_type)

    def reset_parameters(self, example_episode, generator=None) -> None:
        self.feature.reset_parameters(generator)
        self.relation_module.reset_parameters(generator)

    def pair_scores(self, z_proto: torch.Tensor, z_query: torch.Tensor,
                    train: bool = False, stats: dict | None = None,
                    module=None) -> torch.Tensor:
        """Relation scores [..., M, n_way] of every (query, prototype) pair
        of z_proto [..., n_way, C, h, w] and z_query [..., M, C, h, w];
        in train mode BatchNorm is per episode (the leading axis)."""
        lead, n_way = z_proto.shape[:-4], z_proto.shape[-4]
        m = z_query.shape[-4]
        shape = lead + (m, n_way) + self.feat_shape
        pairs = torch.cat([z_proto[..., None, :, :, :, :].expand(shape),
                           z_query[..., :, None, :, :, :].expand(shape)],
                          dim=-3)
        groups = z_proto.shape[0] if (train and lead) else 1
        module = module or self.relation_module
        rel = module(pairs.reshape((-1,) + tuple(pairs.shape[-3:])), train,
                     groups, stats)
        return rel.reshape(lead + (m, n_way))

    def _split(self, z: torch.Tensor):
        s = self.n_support
        z_proto = z[..., :s, :, :, :].mean(-4)
        z_query = z[..., s:, :, :, :].reshape(z.shape[:-5] + (-1,)
                                              + self.feat_shape)
        return z_proto, z_query

    def scores_from_features(self, z: torch.Tensor) -> torch.Tensor:
        """[..., n_way, S+Q, C, h, w] maps -> [..., n_way*Q, n_way]."""
        return self.pair_scores(*self._split(z))

    def loss_of_scores(self, scores: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
        """Per-episode loss [...] of scores [..., M, n_way], labels y [M]."""
        if self.loss_type == "mse":
            onehot = F.one_hot(y, scores.shape[-1]).to(scores.dtype)
            return ((scores - onehot) ** 2).mean((-1, -2))
        return episode_cross_entropy(scores, y)

    def batch_losses_train(self, xb: torch.Tensor):
        z, stats = self.batch_features(xb, train=True)
        scores = self.pair_scores(*self._split(z), train=True, stats=stats)
        y = self.query_labels(xb.shape[1], xb.shape[2] - self.n_support)
        return self.loss_of_scores(scores, y), stats

    @torch.no_grad()
    def adapted_scores_from_features(self, z: torch.Tensor, generator=None,
                                     perms: torch.Tensor | None = None
                                     ) -> torch.Tensor:
        """Scores [E, n_way*Q, n_way] of episodes z [E, n_way, S+Q, C, h,
        w] after finetuning the relation module on each episode's support
        (JAX relationnet.py:156-204): per epoch a permutation of the S
        support images (the same for every way; perms [E, 100, S], else
        drawn from `generator`), prototypes from the first min(3, S-1),
        queries the next min(2, ...), one step of SGD(0.01, momentum 0.9,
        dampening 0.9, weight decay 1e-3) on the weights; BatchNorm stays
        in eval mode with its statistics frozen."""
        from torch.func import functional_call, grad, vmap

        s = self.n_support
        e, n_way = z.shape[0], z.shape[1]
        z_support = z[:, :, :s]
        proto_full, z_query = self._split(z)
        if s < 2:
            return self.pair_scores(proto_full, z_query)
        sub_s = min(3, s - 1)
        sub_q = min(2, s - sub_s)
        y_sub = episode_labels(n_way, sub_q, z.device)
        if perms is None:
            perms = torch.argsort(torch.rand(
                e, ADAPT_EPOCHS, s, generator=generator, device=z.device),
                dim=-1)
        module = self.relation_module
        names = [n for n, _ in module.named_parameters()]
        buffers = dict(module.named_buffers())
        params = [p.detach().expand((e,) + p.shape).clone()
                  for p in module.parameters()]

        def scores(ps, proto, query):
            """One episode's pair scores with the module's weights `ps`."""
            def call(pairs, *args):
                return functional_call(
                    module, {**dict(zip(names, ps)), **buffers},
                    (pairs, *args))
            return self.pair_scores(proto, query, module=call)

        step = vmap(grad(lambda ps, proto, query: self.loss_of_scores(
            scores(ps, proto, query), y_sub)))
        bufs = [None] * len(params)
        rows = torch.arange(e, device=z.device)[:, None, None]
        ways = torch.arange(n_way, device=z.device)[None, :, None]
        for t in range(ADAPT_EPOCHS):
            zz = z_support[rows, ways, perms[:, t][:, None, :]]
            proto = zz[:, :, :sub_s].mean(2)
            query = zz[:, :, sub_s:sub_s + sub_q].reshape(
                (e, -1) + self.feat_shape)
            with torch.enable_grad():
                grads = step(params, proto, query)
            params, bufs = torch_sgd_step(params, list(grads), bufs, t == 0)
        return vmap(scores)(params, proto_full, z_query)
