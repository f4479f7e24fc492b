"""MatchingNet: a bi-LSTM context encoding of the support set and an
attention-LSTM embedding of the queries.

Port of deep_kernel_transfer_tpu/methods/matchingnet.py:28-135 (reference
methods/matchingnet.py:13-100):
  * G encoder: a bidirectional LSTM over the support sequence,
    G = S + fwd + bwd (encode_training_set);
  * FCE: an LSTM cell iterated K = |S| times with softmax attention over
    G, its hidden state residual-summed with the query features each step;
  * scores: relu(cos(F, G))·100, softmax @ one-hot(y_S), log(p + 1e-6),
    and the NLL of those log-probabilities.
The trunk runs in bf16; the LSTMs and the scores stay f32. The LSTMs'
hidden size is the flat feature size. Module names are the reference's
(`G_encoder`, `FCE.lstmcell`), and every episode of a batch is encoded
in one LSTM call.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.backbones import lecun_normal_
from .base import EpisodicMethod, episode_labels, episode_nll


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-5)


def lstm_init_(weight_ih: torch.Tensor, weight_hh: torch.Tensor,
               bias_ih: torch.Tensor, bias_hh: torch.Tensor,
               generator=None) -> None:
    """flax OptimizedLSTMCell's initializers on torch's stacked gates:
    lecun_normal input kernels, orthogonal recurrent kernels (each gate
    its own), zero biases."""
    hidden = weight_hh.shape[1]
    for g in range(4):
        rows = slice(g * hidden, (g + 1) * hidden)
        lecun_normal_(weight_ih[rows], weight_ih.shape[1], generator)
        with torch.no_grad():
            nn.init.orthogonal_(weight_hh[rows], generator=generator)
    with torch.no_grad():
        bias_ih.zero_()
        bias_hh.zero_()


class FullyContextualEmbedding(nn.Module):
    """reference matchingnet.py:73-100: h = f, c = 0; K times a =
    softmax(h Gᵀ), r = a G, (h, c) = LSTMCell([f, r], (h, c)), h += f."""

    def __init__(self, feat_dim: int):
        super().__init__()
        self.lstmcell = nn.LSTMCell(2 * feat_dim, feat_dim)

    def forward(self, f: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
        """f [B, M, D] queries, G [B, K, D] -> [B, M, D]."""
        b, m, d = f.shape
        h, c = f, torch.zeros_like(f)
        for _ in range(G.shape[1]):
            a = torch.softmax(h @ G.transpose(1, 2), dim=-1)
            x = torch.cat([f, a @ G], dim=-1)
            h, c = self.lstmcell(x.reshape(b * m, 2 * d),
                                 (h.reshape(b * m, d), c.reshape(b * m, d)))
            h, c = h.reshape(b, m, d) + f, c.reshape(b, m, d)
        return h


class MatchingNet(EpisodicMethod):
    def __init__(self, backbone: nn.Module, feat_dim: int, n_way: int,
                 n_support: int, lr: float = 1e-3,
                 feature_dtype: str = "bfloat16", device=None):
        super().__init__(n_way, n_support, lr, feature_dtype, device)
        self.feature = backbone
        self.feat_dim = feat_dim
        self.G_encoder = nn.LSTM(feat_dim, feat_dim, batch_first=True,
                                 bidirectional=True)
        self.FCE = FullyContextualEmbedding(feat_dim)

    def reset_parameters(self, example_episode, generator=None) -> None:
        self.feature.reset_parameters(generator)
        for sfx in ("_l0", "_l0_reverse"):
            lstm_init_(*(getattr(self.G_encoder, f"{n}{sfx}") for n in (
                "weight_ih", "weight_hh", "bias_ih", "bias_hh")), generator)
        cell = self.FCE.lstmcell
        lstm_init_(cell.weight_ih, cell.weight_hh, cell.bias_ih,
                   cell.bias_hh, generator)

    def encode_training_set(self, z_s: torch.Tensor) -> torch.Tensor:
        """G = S + fwd + bwd of the support sequences z_s [B, K, D]."""
        out, _ = self.G_encoder(z_s)
        d = self.feat_dim
        return z_s + out[..., :d] + out[..., d:]

    def scores_from_features(self, z: torch.Tensor) -> torch.Tensor:
        """[B, n_way, S+Q, D] features -> [B, n_way*Q, n_way]
        log-probabilities."""
        b, n_way, _, d = z.shape
        s = self.n_support
        z_s = z[:, :, :s].reshape(b, n_way * s, d)
        z_q = z[:, :, s:].reshape(b, -1, d)
        G = self.encode_training_set(z_s)
        F_n = _l2norm(self.FCE(z_q, G))
        scores = F.relu(F_n @ _l2norm(G).transpose(1, 2)) * 100.0
        y_s = F.one_hot(episode_labels(n_way, s, z.device), n_way).to(
            scores.dtype)
        return torch.log(torch.softmax(scores, dim=-1) @ y_s + 1e-6)

    def batch_losses_train(self, xb: torch.Tensor):
        """The NLL of the query log-probabilities (reference
        matchingnet.py:62-68)."""
        z, stats = self.batch_features(xb, train=True)
        y = self.query_labels(xb.shape[1], xb.shape[2] - self.n_support)
        return episode_nll(self.scores_from_features(z), y), stats
