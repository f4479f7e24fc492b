"""window_attention_roofline.train: the least time of a training step's
shifted-window attention on the card over the device time a step of the
kernels named window_attn_fwd and window_attn_bwd, in percent; None where
none ran, or where the trunk's reference lists no attention shapes.

The least time is the larger of two reckonings. Bytes: forward the kernel
must read q, k and v and write o, backward read q, k, v and do and write
dq, dk and dv, 22 bytes an element of [images, tokens, channels] in bf16,
at the card's memory rate; elements a step: the step's images times the
sum of tokens x channels over the blocks
(reference/trunk_<model>.py::attention_shapes). Operations: its seven
products (q k^T and p v forward; do v^T, ds k, ds^T q, p^T do and the
recomputed q k^T backward), each tokens x window^2 x channels
multiply-adds, at the dense bf16 peak. The bias table and the regions are
left out, so the figure stays a lower bound."""
import re

from dkt_bench import flops
from dkt_bench.reference.dkt import trunk

KERNELS = re.compile(r"\bwindow_attn_(fwd|bwd)\b")
BYTES_PER_ELEMENT = 22
PRODUCTS = 7


def read(r):
    if r.mode != "train":
        return None
    shapes = getattr(trunk(r.cfg["model"]), "attention_shapes", None)
    t = sum(s for name, s, _ in r.kernels if KERNELS.search(name))
    if shapes is None or t <= 0:
        return None
    images = r.traffic["episode_batch"] * flops.episode_points(r.traffic)
    blocks = shapes(r.cfg["image_size"])
    elements = images * sum(tok * c for tok, c, _, _, _ in blocks)
    macs = images * sum(tok * m * m * c for tok, c, _, m, _ in blocks)
    bound = max(elements * BYTES_PER_ELEMENT / flops.PEAK_BYTES,
                2.0 * PRODUCTS * macs / flops.PEAK_BF16_FLOPS)
    return 100.0 * bound * r.units / t
