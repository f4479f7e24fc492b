"""The reduction of a traced window to busy time, spans and idle gaps, and
the per-layer metric readers, on synthetic events."""
from __future__ import annotations

import pytest

from dkt_bench import flops
from dkt_bench.registry import Registry
from dkt_bench.trace import Event, Record, summarize

MS = 1_000_000  # ns


def _events():
    """Host: window [0, 100] ms, chunk [0, 90], train_step [10, 50]; ops
    launching a data kernel at 5 ms, a gram kernel and another at 20 and 30
    ms (inside the step). Device: 5-8, 20-30, 28-40 ms (overlapping), and
    a kernel at 60-70 ms launched at 55 ms by an op outside any step."""
    host = [Event("bench.window", False, 0, 100 * MS),
            Event("bench.chunk", False, 0, 90 * MS),
            Event("bench.train_step", False, 10 * MS, 50 * MS),
            Event("aten::rand", False, 5 * MS, 6 * MS, corr=1),
            Event("aten::mm", False, 20 * MS, 21 * MS, corr=2),
            Event("aten::add", False, 30 * MS, 31 * MS, corr=3),
            Event("aten::copy_", False, 55 * MS, 56 * MS, corr=4),
            Event("cudaLaunchKernel", False, 40 * MS, 41 * MS, corr=9)]
    dev = [Event("rand_kernel", True, 5 * MS, 8 * MS, linked=1),
           Event("gram_kernel(float const*)", True, 20 * MS, 30 * MS,
                 linked=2),
           Event("add_kernel", True, 28 * MS, 40 * MS, linked=3),
           Event("copy_kernel", True, 60 * MS, 70 * MS, linked=4)]
    return host + dev


def test_busy_window_and_spans():
    r = summarize(_events(), "train", {}, {}, units=1)
    assert r.window_s == pytest.approx(65e-3)          # 5 .. 70 ms
    assert r.busy_s == pytest.approx((3 + 20 + 10) * 1e-3)
    spans = {name: s for name, _, s in r.kernels}
    assert spans["rand_kernel"] == ("chunk", "window")
    assert spans["add_kernel"] == ("chunk", "train_step", "window")
    assert r.device_ops[0] == ["add_kernel", pytest.approx(12e-3)]
    gaps = dict((round(s * 1e3, 6), name) for name, s in r.idle_gaps)
    assert gaps[20.0] == "bench.train_step > cudaLaunchKernel"  # 40..60
    assert gaps[12.0] == "bench.chunk > no host op"             # 8..20


def test_readers(tmp_path):
    reg = Registry()
    cfg = reg.config("dkt_conv4_miniimagenet")
    tr = reg.traffic("train_5w5s16q_b32")
    r = summarize(_events(), "train", cfg, tr, units=2)
    want_mfu = (100 * 2 * flops.train_step_flops(cfg, tr)
                / (r.window_s * flops.PEAK_BF16_FLOPS))
    assert reg.reader("mfu.train")(r) == pytest.approx(want_mfu)
    assert reg.reader("mfu.eval")(r) is None
    bound = flops.fused_mll_bound_s(32, 105, 1600, 5)
    assert reg.reader("fused_mll_roofline.train")(r) == pytest.approx(
        100 * bound * 2 / 10e-3)
    data = (3 + 10) * 1e-3  # the chunk's kernels launched outside the step
    assert reg.reader("data_share.train")(r) == pytest.approx(
        100 * data / r.busy_s)
    assert reg.reader("idle_share.train")(r) == pytest.approx(
        100 * (1 - 33 / 65))
    assert reg.reader("idle_share.eval")(r) is None


def test_nothing_to_read():
    """No device event: every reader returns nothing, never 0."""
    reg = Registry()
    r = summarize([Event("bench.window", False, 0, MS)], "train",
                  reg.config("dkt_conv4_miniimagenet"),
                  reg.traffic("train_5w5s16q_b32"), 1)
    assert r.busy_s == 0 and r.window_s == 0
    for m in ("mfu.train", "fused_mll_roofline.train", "data_share.train",
              "idle_share.train"):
        assert reg.reader(m)(r) is None
    r2 = Record("train", r.cfg, r.traffic, 1, 1.0, 0.5,
                [("other_kernel", 0.5, ())])
    assert reg.reader("fused_mll_roofline.train")(r2) is None
