"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
training step and an eval batch, and the fused MLL's bound.

Peaks are NVIDIA's datasheet figures for one H100 SXM at its full 700 W
(dense, no sparsity). Model FLOPs count the trunk's products (its
convolutions from their shapes, or the products the trunk module lists in
`macs`) at 2 FLOPs a multiply-add forward; a training step adds twice that
backward, less the input gradient of the first product, which nothing
needs; recomputation is not counted. The GP's work is counted in float32
as the fused MLL's forward bound counts it.
"""
from __future__ import annotations

from .reference.dkt import trunk

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def conv_macs(model: str, size: int) -> list[int]:
    """Multiply-adds of each convolution for one image, in order."""
    return [cin * cout * k * k * h * w
            for cin, cout, k, h, w in trunk(model).conv_shapes(size)]


def trunk_macs(model: str, size: int) -> list[int]:
    """Forward multiply-adds of each of the trunk's products for one
    image, in order, the stem first: the trunk module's `macs(size)` where
    it defines one (a trunk whose products are not all convolutions, such
    as linear layers and attention), else `conv_macs`."""
    t = trunk(model)
    return list(t.macs(size)) if hasattr(t, "macs") else conv_macs(model, size)


def trunk_forward_flops(model: str, size: int) -> float:
    return 2.0 * sum(trunk_macs(model, size))


def trunk_train_flops(model: str, size: int) -> float:
    """Forward, and a backward of twice the forward: each product's two
    operand gradients (of a weight and an input, or, for a product of two
    activations such as attention's Q K^T and A V, of both activations),
    less the input gradient of the first product, which nothing needs."""
    macs = trunk_macs(model, size)
    return 2.0 * (3 * sum(macs) - macs[0])


def fused_mll_flops(b: int, n: int, d: int, w: int) -> float:
    """The Gram's lower triangle with its diagonal (B N(N+1) D), then a
    Cholesky with its explicit inverse (2N^3/3) and the two products with
    the inverse (2N^2) for each (episode, way)."""
    return 1.0 * b * n * (n + 1) * d + b * w * (2.0 * n ** 3 / 3.0
                                                 + 2.0 * n * n)


def fused_mll_bytes(b: int, n: int, d: int, w: int) -> float:
    """Z, the shared diffs and scales read once; the MLLs, L^-1, alpha and
    the Gram written once, float32."""
    return 4.0 * (b * n * d + (w * n + w) + b * w + b * w * n * n
                  + b * w * n + b * n * n)


def fused_mll_bound_s(b: int, n: int, d: int, w: int) -> float:
    """Least time of the fused MLL's forward on the card: the larger of
    its float32 operations at the FFMA peak and its bytes at the memory
    rate."""
    return max(fused_mll_flops(b, n, d, w) / PEAK_F32_FLOPS,
               fused_mll_bytes(b, n, d, w) / PEAK_BYTES)


def feat_dim(cfg: dict) -> int:
    return trunk(cfg["model"]).feat_dim(cfg["image_size"])


def episode_points(traffic: dict) -> int:
    return traffic["n_way"] * (traffic["n_support"] + traffic["n_query"])


def train_step_flops(cfg: dict, traffic: dict) -> float:
    """One training step: every image's trunk forward and backward, and
    the fused MLL's forward."""
    b, n = traffic["episode_batch"], episode_points(traffic)
    return (b * n * trunk_train_flops(cfg["model"], cfg["image_size"])
            + fused_mll_flops(b, n, feat_dim(cfg), traffic["n_way"]))


def eval_batch_flops(cfg: dict, traffic: dict, b: int) -> float:
    """One eval batch of b episodes: every image's trunk forward, and the
    posterior's support Gram and support-query products."""
    n_s = traffic["n_way"] * traffic["n_support"]
    n_q = traffic["n_way"] * traffic["n_query"]
    return (b * (n_s + n_q) * trunk_forward_flops(cfg["model"],
                                                   cfg["image_size"])
            + 2.0 * b * n_s * (n_s + n_q) * feat_dim(cfg))


def protocol_flops(cfg: dict, traffic: dict) -> float:
    full, rem = divmod(traffic["protocol_episodes"], traffic["episode_batch"])
    return (full * eval_batch_flops(cfg, traffic, traffic["episode_batch"])
            + (eval_batch_flops(cfg, traffic, rem) if rem else 0.0))
