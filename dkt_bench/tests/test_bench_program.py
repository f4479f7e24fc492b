"""The program's spans in a traced window (program.py): kernels charged to
their spans, a backward kernel to its forward op's spans, host syncs by
innermost span, idle gaps named by program span, and the readings; on the
synthetic events of test_bench_trace.py with program spans added (the six
accepted readers read the same with them), and on a traced tiny cell."""
from __future__ import annotations

import dataclasses

import pytest

from dkt_bench import program, trace
from dkt_bench.program import Event, summarize
from dkt_bench.registry import Registry
from test_bench_trace import MS, _events

MAIN, AUTOGRAD = 1, 2  # thread ids


def _base():
    """test_bench_trace's events on the main thread, its add op on the
    autograd thread, and a kernel at 80-85 ms launched at 75 ms outside
    every program span."""
    out = []
    for e in _events():
        e = Event(**dataclasses.asdict(e))
        if not e.device:
            e.thread = AUTOGRAD if e.name == "aten::add" else MAIN
        out.append(e)
    return out + [Event("aten::fill_", False, 75 * MS, 76 * MS, corr=5,
                        thread=MAIN),
                  Event("fill_kernel", True, 80 * MS, 85 * MS, linked=5)]


def _program():
    """Spans: draw 4-9 (augment 4.5-6.5 holds the rand op at 5), step
    11-49 holding forward 12-25 (trunk 13-19 with a batchnorm at 14-16
    whose mul op at 15 has sequence number 7, gp 19.5-24 holding the mm at
    20), backward 26-45 (its MulBackward0 op 29.5-32 on the autograd
    thread holds the add at 30) and update 46-49. Syncs: one in augment,
    one in update, one outside every program span; an async copy in
    batchnorm."""
    def span(name, a, b):
        return Event("dkt." + name, False, int(a * MS), int(b * MS),
                     thread=MAIN)

    return [span("draw", 4, 9), span("augment", 4.5, 6.5),
            span("step", 11, 49), span("forward", 12, 25),
            span("trunk", 13, 19), span("batchnorm", 14, 16),
            span("gp", 19.5, 24), span("backward", 26, 45),
            span("update", 46, 49),
            Event("aten::mul", False, 15 * MS, int(15.5 * MS), seq=7,
                  thread=MAIN),
            Event(program.BACKWARD + "MulBackward0", False, int(29.5 * MS),
                  32 * MS, seq=7, fwd_thread=MAIN, thread=AUTOGRAD),
            Event("cudaStreamSynchronize", False, 6 * MS, int(6.2 * MS),
                  thread=MAIN),
            Event("cudaMemcpy", False, 47 * MS, int(47.1 * MS), thread=MAIN),
            Event("cudaStreamSynchronize", False, 52 * MS, 53 * MS,
                  thread=MAIN),
            Event("cudaMemcpyAsync", False, 15 * MS, int(15.1 * MS),
                  thread=MAIN)]


def _with_spans():
    return _base() + _program()


def test_accepted_readers_read_the_same_with_program_spans():
    reg = Registry()
    cfg = reg.config("dkt_conv4_miniimagenet")
    tr = reg.traffic("train_5w5s16q_b32")
    old = trace.summarize(_base(), "train", cfg, tr, units=2)
    new = trace.summarize(_with_spans(), "train", cfg, tr, units=2)
    assert (new.window_s, new.busy_s) == (old.window_s, old.busy_s)
    assert new.kernels == old.kernels and new.device_ops == old.device_ops
    for m in ("mfu.train", "fused_mll_roofline.train", "data_share.train",
              "idle_share.train"):
        assert reg.reader(m)(new) == pytest.approx(reg.reader(m)(old)), m


def test_kernels_charged_to_their_spans():
    p = summarize(_with_spans(), "train", units=2)
    spans = {name: names for name, _, names in p.kernels}
    assert spans["rand_kernel"] == ("augment", "draw")
    assert spans["gram_kernel(float const*)"] == ("forward", "gp", "step")
    # launched in the backward by the op that the batchnorm's mul made
    assert spans["add_kernel"] == ("backward", "batchnorm", "forward",
                                   "step", "trunk")
    assert spans["copy_kernel"] == spans["fill_kernel"] == ()
    assert p.spans == {"draw": 1, "augment": 1, "step": 1, "forward": 1,
                       "trunk": 1, "batchnorm": 1, "gp": 1, "backward": 1,
                       "update": 1}


def test_syncs_by_innermost_span():
    p = summarize(_with_spans(), "train", units=2)
    assert p.syncs == {"augment": 1, "update": 1}
    assert p.sync_calls == 3


def test_gaps_named_by_program_span():
    p = summarize(_with_spans(), "train", units=2)
    gaps = dict((round(s * 1e3, 6), name) for name, s in p.idle_gaps)
    assert gaps[20.0] == "bench.train_step > dkt.backward > cudaLaunchKernel"
    assert gaps[12.0] == "bench.chunk > dkt.draw > no host op"
    # outside every program span: trace.py's name
    old = dict((round(s * 1e3, 6), name) for name, s in trace.summarize(
        _base(), "train", {}, {}, 2).idle_gaps)
    assert gaps[10.0] == old[10.0] == "bench.chunk > no host op"


def test_readings():
    p = summarize(_with_spans(), "train", units=2)
    read = {k: v["value"] for k, v in program.readings(p).items()}
    assert read == pytest.approx({
        "trunk_ms.train": 12 / 2, "batchnorm_ms.train": 12 / 2,
        "gp_ms.train": 10 / 2, "draw_ms.train": 3 / 2,
        "host_syncs.train": 2 / 2})
    assert program.span_ms(p, "update", "train") is None  # no kernel
    assert program.charged_share(p) == pytest.approx(100 * 25 / 40)
    rep = program.report(p)
    assert rep["span_ms"]["backward"] == pytest.approx(6.0)
    assert set(rep["readings"]) == set(read)


def test_nothing_to_read():
    """No program span: every reading returns nothing, never 0; an eval
    window gives no train reading."""
    p = summarize(_base(), "train", units=2)
    assert program.readings(p) == {}
    assert p.idle_gaps == trace.summarize(_base(), "train", {}, {},
                                          2).idle_gaps
    e = summarize(_with_spans(), "eval", units=1)
    assert set(program.readings(e)) == {"trunk_ms.eval", "host_syncs.eval"}
    assert program.charged_share(summarize([], "train", 1)) is None


def test_traced_tiny_cell(tiny):
    """A traced tiny training window on the CPU through run.run_cell: the
    result line as run.py makes it, and each span of the step and the
    feed once a step (no device kernels on the CPU)."""
    result, p = program.traced_cell(tiny, "tiny_train", 3, device="cpu")
    assert result["correct"] and "breakdown" in result
    steps = tiny.traffic("tiny_train")["trace_steps"]
    for span in ("step", "forward", "backward", "update", "trunk", "gp",
                 "draw", "augment"):
        assert p.spans[span] == steps, span
    assert p.spans["batchnorm"] == 5 * steps  # Conv4 and bn_out
    assert program.readings(p) == {"host_syncs.train": {
        "value": 0.0, "unit": "syncs/step"}}


def test_main_needs_a_card(monkeypatch, capsys):
    import torch

    from dkt_bench import run

    for var, _ in run.CACHES:  # main sets them; restored after the test
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert program.main(["--workload", "conv4_mini_train_b32",
                         "--seed", "1"]) == 2
    assert "CUDA" in capsys.readouterr().err
