"""mfu.train: model FLOPs of the traced training steps over the traced
window at the card's dense bf16 peak (readers.mfu)."""
from dkt_bench import readers


def read(r):
    return readers.mfu(r, "train")
