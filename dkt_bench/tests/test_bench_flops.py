"""The yardstick's FLOP and byte counts against sums written out by hand."""
from __future__ import annotations

import pytest

from dkt_bench import flops
from dkt_bench.registry import Registry


def test_conv4_macs_by_hand():
    # 84 px: conv1 at 84x84 from 3 channels, then 42, 21, 10 from 64
    hand = [84 * 84 * 64 * 27, 42 * 42 * 64 * 576, 21 * 21 * 64 * 576,
            10 * 10 * 64 * 576]
    assert flops.conv_macs("Conv4", 84) == hand
    assert flops.trunk_forward_flops("Conv4", 84) == 2 * sum(hand)
    assert flops.trunk_train_flops("Conv4", 84) == 2 * (3 * sum(hand)
                                                        - hand[0])


def test_resnet10_macs_by_hand():
    stem = 112 * 112 * 64 * 3 * 49
    b1 = 2 * 56 * 56 * 64 * 64 * 9
    b2 = 28 * 28 * 128 * (64 * 9 + 128 * 9 + 64)
    b3 = 14 * 14 * 256 * (128 * 9 + 256 * 9 + 128)
    b4 = 7 * 7 * 512 * (256 * 9 + 512 * 9 + 256)
    macs = flops.conv_macs("ResNet10", 224)
    assert macs[0] == stem
    assert sum(macs) == stem + b1 + b2 + b3 + b4
    assert flops.trunk_train_flops("ResNet10", 224) == pytest.approx(
        2 * (3 * sum(macs) - stem))


def test_fused_mll_bound():
    """The bound of chip_smoke.py's fused_mll_bound_ms, frozen here:
    10.40 us at the Conv4 step's shapes, by operations."""
    b, n, d, w = 32, 105, 1600, 5
    ops = b * n * (n + 1) * d + b * w * (2 * n ** 3 / 3 + 2 * n * n)
    assert flops.fused_mll_flops(b, n, d, w) == pytest.approx(ops)
    assert flops.fused_mll_bound_s(b, n, d, w) == pytest.approx(ops / 67e12)
    assert flops.fused_mll_bound_s(b, n, d, w) * 1e6 == pytest.approx(10.40,
                                                                      abs=0.01)
    nbytes = 4 * (16 * 105 * 512 + 5 * 105 + 5 + 16 * 5 + 16 * 5 * 105 ** 2
                  + 16 * 5 * 105 + 16 * 105 ** 2)
    assert flops.fused_mll_bytes(16, 105, 512, 5) == nbytes


def test_step_and_protocol_flops():
    reg = Registry()
    cfg = reg.config("dkt_conv4_miniimagenet")
    tr = reg.traffic("train_5w5s16q_b32")
    assert flops.train_step_flops(cfg, tr) == pytest.approx(
        3360 * flops.trunk_train_flops("Conv4", 84)
        + flops.fused_mll_flops(32, 105, 1600, 5))
    ev = reg.traffic("eval600_5w5s15q_b32")
    per = flops.trunk_forward_flops("Conv4", 84)
    full = 32 * 100 * per + 2 * 32 * 25 * 100 * 1600
    last = 24 * 100 * per + 2 * 24 * 25 * 100 * 1600
    assert flops.protocol_flops(cfg, ev) == pytest.approx(18 * full + last)
