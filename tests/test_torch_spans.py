"""The port's spans (utils/profiling.py::annotate) in torch.profiler traces
on the CPU: a DKT train step on ConvNet(2) with the bncossim head (the
fused MLL's plain version and the ExactGP engine), an eval batch, and the
on-card feed of a DeviceDataset built from arrays. Each span opens once a
call, nested as the module docstring of utils/profiling.py lists, and the
autograd ops of the backward carry the sequence number of a forward op
inside the span that made them. Torch is held to one thread.
"""
import contextlib

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from deep_kernel_transfer_tpu_torch.data.device_dataset import (
    DeviceDataset, make_fused_epoch)
from deep_kernel_transfer_tpu_torch.methods import DKT
from deep_kernel_transfer_tpu_torch.methods.base import train_step_body
from deep_kernel_transfer_tpu_torch.models import ConvNet
from deep_kernel_transfer_tpu_torch.models.backbones import EpisodicBatchNorm
from deep_kernel_transfer_tpu_torch.utils.profiling import (SPAN_PREFIX,
                                                            annotate)
from torch_test_threads import one_thread  # noqa: F401

B, WAY, SHOT, QUERY, PX, CANVAS = 2, 5, 2, 3, 16, 19
BACKWARD = "autograd::engine::evaluate_function: "
STEP_SPANS = {"step": None, "forward": "step", "backward": "step",
              "update": "step", "trunk": "forward", "gp": "forward"}


def _model(fused: bool) -> DKT:
    x = torch.zeros((WAY, SHOT + QUERY, PX, PX, 3), dtype=torch.uint8)
    gen = torch.Generator().manual_seed(0)
    return DKT(ConvNet(2), WAY, SHOT, "bncossim", feature_dtype="float32",
               use_fused_mll=fused, device="cpu").init(x, gen)


def _episodes(seed: int = 0) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, WAY, SHOT + QUERY, PX, PX, 3),
                         generator=gen, dtype=torch.uint8)


def _host_events(fn) -> list:
    """(name, start, end, sequence_nr, forward thread, thread) of each
    host event of a CPU trace of fn()."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.sequence_nr(), e.fwd_thread_id(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def _spans(events) -> dict:
    """{span name without the prefix: [(start, end)]}"""
    out: dict = {}
    for name, start, end, *_ in events:
        if name.startswith(SPAN_PREFIX):
            out.setdefault(name[len(SPAN_PREFIX):], []).append((start, end))
    return out


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _n_batchnorms(model) -> int:
    return sum(isinstance(m, EpisodicBatchNorm) for m in model.modules())


def test_annotate_is_a_no_op_without_a_profiler():
    ctx = annotate("idle")
    assert isinstance(ctx, contextlib.nullcontext)
    with ctx:
        pass
    events = _host_events(lambda: annotate("traced").__enter__().__exit__(
        None, None, None))
    assert [e[0] for e in events if e[0].startswith(SPAN_PREFIX)] == [
        "dkt.traced"]


@pytest.fixture(scope="module", params=[True, False], ids=["fused", "engine"])
def train_trace(request):
    model = _model(request.param)
    x = _episodes()
    return model, request.param, _host_events(lambda: model.train_step(x))


def test_train_step_spans_nest(train_trace):
    model, _, events = train_trace
    spans = _spans(events)
    assert set(spans) == set(STEP_SPANS) | {"batchnorm"}
    for name, parent in STEP_SPANS.items():
        assert len(spans[name]) == 1, name
        if parent:
            assert _within(spans[name][0], spans[parent][0]), name
    assert len(spans["batchnorm"]) == _n_batchnorms(model) == 3
    for bn in spans["batchnorm"]:
        assert _within(bn, spans["trunk"][0])
    (fwd,), (bwd,), (upd,) = (spans[k] for k in ("forward", "backward",
                                                   "update"))
    assert fwd[1] <= bwd[0] and bwd[1] <= upd[0]
    assert spans["trunk"][0][1] <= spans["gp"][0][0]


def test_average_span_between_backward_and_update():
    model = _model(True)
    seen = []
    x = _episodes()
    spans = _spans(_host_events(
        lambda: train_step_body(model, x, average=seen.append)))
    assert len(seen) == 1 and len(spans["average"]) == 1
    (avg,), (step,) = spans["average"], spans["step"]
    assert _within(avg, step)
    assert (spans["backward"][0][1] <= avg[0] <= avg[1]
            <= spans["update"][0][0])


def test_backward_maps_to_its_forward_span(train_trace):
    """Each backward op's sequence number names a forward op of the same
    thread; the BatchNorms' backward ops map to forward ops inside
    dkt.batchnorm, the MLL's inside dkt.gp, and every backward op runs
    inside dkt.backward."""
    _, fused, events = train_trace
    spans = _spans(events)
    forward = {(thread, seq): (name, start)
               for name, start, _, seq, fwd_thread, thread in events
               if seq >= 0 and fwd_thread == 0}
    charged: dict = {"batchnorm": set(), "gp": set()}
    n_backward = 0
    for name, start, end, seq, fwd_thread, _ in events:
        if not name.startswith(BACKWARD) or seq < 0:
            continue
        n_backward += 1
        assert _within((start, end), spans["backward"][0]), name
        _, t = forward[(fwd_thread, seq)]
        for span, names in charged.items():
            if any(a <= t <= b for a, b in spans[span]):
                names.add(name[len(BACKWARD):])
    assert n_backward > 10
    assert "RsqrtBackward0" in charged["batchnorm"] - charged["gp"]
    mll = "_FusedLinearMLLBackward" if fused else "LinalgCholeskyExBackward0"
    assert mll in charged["gp"] - charged["batchnorm"], charged["gp"]


def test_eval_batch_spans():
    model = _model(True)
    x = _episodes(1)
    with torch.no_grad():
        spans = _spans(_host_events(lambda: model.batch_logits(x)))
    assert set(spans) == {"trunk", "batchnorm", "posterior"}
    assert len(spans["trunk"]) == len(spans["posterior"]) == 1
    assert len(spans["batchnorm"]) == _n_batchnorms(model)
    assert spans["trunk"][0][1] <= spans["posterior"][0][0]


def _canvas_split(n_class: int = 7, per_class: int = 6):
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (n_class * per_class, CANVAS, CANVAS, 3),
                           generator=gen, dtype=torch.uint8)
    table = torch.arange(n_class * per_class).reshape(n_class, per_class)
    table = table.repeat(1, 128 // per_class + 1)[:, :128]
    counts = torch.full((n_class,), per_class)
    return images, table, counts


def test_from_arrays_draws_from_the_given_split():
    images, table, counts = _canvas_split()
    ds = DeviceDataset.from_arrays(images, table, counts, canvas=False)
    assert ds.device == images.device and ds.mesh is None
    assert ds.images is images and ds.table is table and ds.counts is counts
    x = ds.sample_episodes(torch.Generator().manual_seed(0), WAY, SHOT, QUERY,
                           batch=2)
    assert x.shape == (2, WAY, SHOT + QUERY, CANVAS, CANVAS, 3)
    flat = images.reshape(images.shape[0], -1)
    for img in x.reshape(-1, flat.shape[1]):
        assert (flat == img).all(dim=1).any()
    with pytest.raises(ValueError, match="canvas"):
        ds.epoch(0, WAY, SHOT, QUERY, 2, augment_to=PX).__next__()


def test_feed_spans():
    """make_fused_epoch: dkt.draw (dkt.augment inside it) once a step,
    before and outside dkt.step; sample_episodes: dkt.draw alone."""
    ds = DeviceDataset.from_arrays(*_canvas_split(), canvas=True)
    model = _model(True)
    chunk = make_fused_epoch(model, ds, WAY, SHOT, QUERY, B, augment_to=PX)
    gen = torch.Generator().manual_seed(1)
    spans = _spans(_host_events(lambda: chunk(gen, 2)))
    assert len(spans["draw"]) == len(spans["augment"]) == 2
    assert len(spans["step"]) == 2
    for draw, aug, step in zip(spans["draw"], spans["augment"],
                               spans["step"]):
        assert _within(aug, draw) and draw[1] <= step[0]
    plain = DeviceDataset.from_arrays(*_canvas_split())
    spans = _spans(_host_events(
        lambda: plain.sample_episodes(gen, WAY, SHOT, QUERY, B)))
    assert {k: len(v) for k, v in spans.items()} == {"draw": 1}
