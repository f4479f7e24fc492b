"""ProtoNet: prototypes are the support means, scores the negative squared
euclidean distances.

Port of deep_kernel_transfer_tpu/methods/protonet.py:19-59 (reference
methods/protonet.py:11-49): a bf16 trunk, f32 distances from norms and one
product (gp.kernels.sq_dist).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..gp.kernels import sq_dist
from .base import EpisodicMethod


class ProtoNet(EpisodicMethod):
    def __init__(self, backbone: nn.Module, n_way: int, n_support: int,
                 lr: float = 1e-3, feature_dtype: str = "bfloat16",
                 device=None):
        super().__init__(n_way, n_support, lr, feature_dtype, device)
        self.feature = backbone

    def reset_parameters(self, example_episode, generator=None) -> None:
        self.feature.reset_parameters(generator)

    def scores_from_features(self, z: torch.Tensor) -> torch.Tensor:
        """[..., n_way, S+Q, D] features -> [..., n_way*Q, n_way] scores."""
        s = self.n_support
        z_proto = z[..., :s, :].mean(-2)
        z_query = z[..., s:, :].reshape(z.shape[:-3] + (-1, z.shape[-1]))
        return -sq_dist(z_query, z_proto)
