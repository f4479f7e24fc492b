"""idle_share.eval: the traced window's idle share (readers.idle_share)."""
from dkt_bench import readers


def read(r):
    return readers.idle_share(r, "eval")
