"""The traced window: the harness's spans, torch.profiler's events, and the
record that the per-layer metric readers read.

The program has no spans of its own, so the harness opens them around the
public calls it makes (`bench.window`, `bench.chunk`, `bench.train_step`,
`bench.protocol`, `bench.eval_batch`, `bench.readback`). A device event
is placed by the host op that launched it: its linked CPU op's start time
falls inside zero or more harness spans.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "bench."
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this length


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclass
class Event:
    """One profiler event, times in ns on the host's clock."""
    name: str
    device: bool          # ran on the card
    start: int
    end: int
    corr: int = 0         # correlation id (host ops)
    linked: int = 0       # the launching host op's id (device events)


@dataclass
class Record:
    """What a traced window gives the per-layer metric readers."""
    mode: str
    cfg: dict
    traffic: dict
    units: int                     # steps, or protocols, in the window
    window_s: float                # first device event start to last end
    busy_s: float                  # union of the device events
    kernels: list = field(default_factory=list)  # [(name, s, spans)]
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def profiler_events(prof) -> list[Event]:
    """The kineto events of a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and (e.is_user_annotation()
                    or e.name().startswith(SPAN_PREFIX)):
            continue  # the device-side copy of a host span
        start = e.start_ns()
        out.append(Event(e.name(), dev, start, start + e.duration_ns(),
                         e.correlation_id(), e.linked_correlation_id()))
    return out


def _spans(events):
    """{span name: sorted [(start, end)]} of the harness's host spans."""
    out: dict = {}
    for e in events:
        if not e.device and e.name.startswith(SPAN_PREFIX):
            out.setdefault(e.name[len(SPAN_PREFIX):], []).append(
                (e.start, e.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(intervals, t) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def summarize(events: list[Event], mode: str, cfg: dict, traffic: dict,
              units: int, top: int = 10) -> Record:
    """Device busy time as the union of the device events, the window
    from the first device start to the last device end, each device
    event's time and the harness spans its launch fell in, the top device
    ops by time, and the longest idle gaps, each named by the harness
    span and the host op the host was in when the card fell idle."""
    dev = sorted((e for e in events if e.device), key=lambda e: e.start)
    if not dev:
        return Record(mode, cfg, traffic, units, 0.0, 0.0)
    host = [e for e in events if not e.device]
    # the launching op by its id; the runtime call where no op matches
    ops, runtime = {}, {}
    for e in host:
        if e.corr:
            (runtime if e.name.startswith("cu") else ops).setdefault(
                e.corr, e.start)
    spans = _spans(events)
    kernels = []
    for e in dev:
        t = ops.get(e.linked, runtime.get(e.linked))
        names = tuple(sorted(n for n, iv in spans.items()
                             if t is not None and _inside(iv, t)))
        kernels.append((e.name, (e.end - e.start) * 1e-9, names))
    merged = []
    for e in dev:
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    busy = sum(b - a for a, b in merged) * 1e-9
    window = (merged[-1][1] - merged[0][0]) * 1e-9
    by_name: dict = {}
    for name, s, _ in kernels:
        by_name[name] = by_name.get(name, 0.0) + s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    idle = [[_host_state(host, t), g * 1e-9] for g, t in gaps]
    return Record(mode, cfg, traffic, units, window, busy, kernels,
                  [[n[:NAME_CHARS], s] for n, s in device_ops], idle)


def _host_state(host: list[Event], t: int) -> str:
    """The innermost harness span and the innermost other host op that
    were open at time t."""
    best_span, best_op = None, None
    for e in host:
        if e.start <= t <= e.end:
            if e.name.startswith(SPAN_PREFIX):
                if best_span is None or e.start >= best_span.start:
                    best_span = e
            elif best_op is None or e.start >= best_op.start:
                best_op = e
    return " > ".join([best_span.name if best_span else "no span",
                       best_op.name if best_op else "no host op"])
