"""mfu.eval: model FLOPs of the traced 600-episode protocols over the
traced window at the card's dense bf16 peak (readers.mfu)."""
from dkt_bench import readers


def read(r):
    return readers.mfu(r, "eval")
