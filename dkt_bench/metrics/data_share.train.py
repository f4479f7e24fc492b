"""data_share.train: the feed's device time over the busy time
(readers.data_share)."""
from dkt_bench import readers


def read(r):
    return readers.data_share(r)
