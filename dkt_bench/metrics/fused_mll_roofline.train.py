"""fused_mll_roofline.train: the fused MLL forward's bound over the device
time a step of the kernels named here (readers.fused_mll_roofline)."""
import re

from dkt_bench import readers

KERNELS = re.compile(r"\b(gram_kernel|episode_kernel)\b")


def read(r):
    return readers.fused_mll_roofline(r, KERNELS)
