"""The program's own spans in a traced window, and the per-layer readings
they give.

The port opens `dkt.` spans at its layer boundaries (`dkt.step`,
`dkt.forward`, `dkt.backward`, `dkt.average`, `dkt.update`, `dkt.trunk`,
`dkt.batchnorm`, `dkt.gp`, `dkt.posterior`, `dkt.draw`, `dkt.augment`;
deep_kernel_transfer_tpu_torch/utils/profiling.py). Here

  * each device kernel is charged to the program spans its launch fell in
    (by time), and a kernel launched by an autograd backward op also to
    the spans of the forward op that made it: the backward op carries
    that forward op's sequence number and thread;
  * the host-blocking runtime calls are counted by the innermost program
    span open at each;
  * each idle gap is named `<harness span> > <program span> > <host op>`,
    the middle part left out where no program span is open.

run.py's traced window keeps none of these event fields, so its result
line carries no program reading. This module's command runs a cell's
traced window through run.run_cell with them and prints the readings:

    python3 -m dkt_bench.program --workload <cell> --seed <n>
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from dataclasses import dataclass, field
from unittest import mock

import torch

from dkt_bench import trace

PREFIX = "dkt."
BACKWARD = "autograd::engine::evaluate_function: "
# runtime calls that block the host until the card catches up
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


@dataclass
class Event(trace.Event):
    """A profiler event with its autograd sequence number (-1: none), the
    thread of the forward op that made a backward op (0 on forward ops)
    and the thread it ran on."""
    seq: int = -1
    fwd_thread: int = 0
    thread: int = 0


@dataclass
class Program:
    """What the program's spans give a traced window."""
    mode: str
    units: int                                   # steps, or protocols
    spans: dict = field(default_factory=dict)    # {span: times opened}
    kernels: list = field(default_factory=list)  # [(name, s, spans)]
    syncs: dict = field(default_factory=dict)    # {innermost span: calls}
    sync_calls: int = 0                          # in the whole window
    idle_gaps: list = field(default_factory=list)


def profiler_events(prof) -> list[Event]:
    """trace.profiler_events with the sequence numbers and threads."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() == DeviceType.CUDA
        if dev and (e.is_user_annotation()
                    or e.name().startswith((trace.SPAN_PREFIX, PREFIX))):
            continue  # the device-side copy of a host span
        start = e.start_ns()
        out.append(Event(e.name(), dev, start, start + e.duration_ns(),
                         e.correlation_id(), e.linked_correlation_id(),
                         e.sequence_nr(), e.fwd_thread_id(),
                         e.start_thread_id()))
    return out


def _program_spans(events) -> dict:
    """{span name without the prefix: sorted [(start, end)]} of the host's
    program spans (spans of one name never overlap)."""
    out: dict = {}
    for e in events:
        if not e.device and e.name.startswith(PREFIX):
            out.setdefault(e.name[len(PREFIX):], []).append((e.start, e.end))
    return {k: sorted(v) for k, v in out.items()}


def _holding(intervals, t):
    """The interval of the sorted, disjoint `intervals` that holds t."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return intervals[i] if i >= 0 and intervals[i][1] >= t else None


def _open_at(spans: dict, t) -> set:
    return ({n for n, iv in spans.items() if _holding(iv, t)}
            if t is not None else set())


def _innermost(spans: dict, t):
    """The latest-opened program span holding t, or None."""
    best, start = None, None
    for name, iv in spans.items():
        hit = _holding(iv, t)
        if hit and (start is None or hit[0] >= start):
            best, start = name, hit[0]
    return best


def summarize(events: list, mode: str, units: int,
              top: int = 10) -> Program:
    """The program's spans in a traced window of `units` steps or
    protocols."""
    host = [e for e in events if not e.device]
    dev = sorted((e for e in events if e.device), key=lambda e: e.start)
    spans = _program_spans(events)
    counts = {n: len(iv) for n, iv in spans.items()}
    # the launching host op by its id; the runtime call where no op matches
    ops, runtime = {}, {}
    for e in host:
        if e.corr:
            (runtime if e.name.startswith("cu") else ops).setdefault(
                e.corr, e)
    forward, backward = {}, {}
    for e in host:
        if e.seq < 0:
            continue
        if e.name.startswith(BACKWARD):
            backward.setdefault(e.thread, []).append((e.start, e.end, e))
        elif e.fwd_thread == 0:
            forward.setdefault((e.thread, e.seq), e.start)
    backward = {k: (sorted(v, key=lambda x: x[:2]), sorted(x[0] for x in v))
                for k, v in backward.items()}

    def made_by(op):
        """The start of the forward op whose backward launched `op`."""
        ivs, starts = backward.get(op.thread, ((), ()))
        i = bisect.bisect_right(starts, op.start) - 1
        if i >= 0 and ivs[i][1] >= op.start:
            b = ivs[i][2]
            return forward.get((b.fwd_thread, b.seq))
        return None

    kernels = []
    for e in dev:
        op = ops.get(e.linked) or runtime.get(e.linked)
        names = _open_at(spans, op.start if op else None)
        if op is not None:
            names |= _open_at(spans, made_by(op))
        kernels.append((e.name, (e.end - e.start) * 1e-9,
                        tuple(sorted(names))))
    syncs: dict = {}
    n_sync = 0
    for e in host:
        if e.name in SYNC_CALLS:
            n_sync += 1
            name = _innermost(spans, e.start)
            if name:
                syncs[name] = syncs.get(name, 0) + 1
    merged = []
    for e in dev:
        if merged and e.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end)
        else:
            merged.append([e.start, e.end])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    idle = [[host_state(host, spans, t), g * 1e-9] for g, t in gaps]
    return Program(mode, units, counts, kernels, syncs, n_sync, idle)


def host_state(host: list, spans: dict, t: int) -> str:
    """The innermost harness span, program span and other host op open at
    time t; trace._host_state's name where no program span is open."""
    best_span, best_op = None, None
    for e in host:
        if e.start <= t <= e.end and not e.name.startswith(PREFIX):
            if e.name.startswith(trace.SPAN_PREFIX):
                if best_span is None or e.start >= best_span.start:
                    best_span = e
            elif best_op is None or e.start >= best_op.start:
                best_op = e
    program = _innermost(spans, t)
    return " > ".join([best_span.name if best_span else "no span"]
                      + ([PREFIX + program] if program else [])
                      + [best_op.name if best_op else "no host op"])


# ---------------------------------------------------------------- readings


def span_ms(p: Program, span: str, mode: str):
    """Device ms a step (train) or protocol (eval) of the kernels charged
    to the span, forward and backward; None where none is."""
    if p.mode != mode:
        return None
    t = sum(s for _, s, names in p.kernels if span in names)
    return 1e3 * t / p.units if t > 0 else None


def host_syncs(p: Program, mode: str):
    """Host-blocking runtime calls inside program spans a step or
    protocol; None where the window holds no program span."""
    if p.mode != mode or not p.spans:
        return None
    return sum(p.syncs.values()) / p.units


def charged_share(p: Program):
    """The share of the kernels' device time charged to some program
    span, in percent; None without a kernel."""
    total = sum(s for _, s, _ in p.kernels)
    if total <= 0:
        return None
    return 100.0 * sum(s for _, s, names in p.kernels if names) / total


READINGS = {  # name: (reading, unit)
    "trunk_ms.train": (lambda p: span_ms(p, "trunk", "train"), "ms"),
    "batchnorm_ms.train": (lambda p: span_ms(p, "batchnorm", "train"), "ms"),
    "gp_ms.train": (lambda p: span_ms(p, "gp", "train"), "ms"),
    "update_ms.train": (lambda p: span_ms(p, "update", "train"), "ms"),
    "draw_ms.train": (lambda p: span_ms(p, "draw", "train"), "ms"),
    "host_syncs.train": (lambda p: host_syncs(p, "train"), "syncs/step"),
    "trunk_ms.eval": (lambda p: span_ms(p, "trunk", "eval"), "ms"),
    "posterior_ms.eval": (lambda p: span_ms(p, "posterior", "eval"), "ms"),
    "host_syncs.eval": (lambda p: host_syncs(p, "eval"), "syncs/protocol"),
}


def readings(p: Program) -> dict:
    """Every reading that finds something to read: {name: {value, unit}}."""
    out = {}
    for name, (read, unit) in READINGS.items():
        v = read(p)
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def report(p: Program) -> dict:
    """The readings, each span's device ms a unit, the charged share, the
    syncs and the named idle gaps."""
    every = sorted({n for _, _, names in p.kernels for n in names})
    return {"readings": readings(p),
            "span_ms": {n: span_ms(p, n, p.mode) for n in every},
            "charged_share": charged_share(p), "spans": p.spans,
            "syncs": p.syncs, "sync_calls_in_window": p.sync_calls,
            "idle_gaps": p.idle_gaps}


def traced_cell(reg, name: str, seed: int, device="cuda",
                t_start: float | None = None):
    """One traced run of the cell (run.run_cell) with the program's event
    fields kept: (the result line's dict, Program)."""
    from dkt_bench import run

    tr = reg.traffic(reg.cell(name)["traffic"])
    captured = []

    def capture(prof):
        captured.append(profiler_events(prof))
        return captured[-1]

    with mock.patch.object(trace, "profiler_events", capture):
        result, _, _, _ = run.run_cell(reg, name, seed,
                                       reg.bench["run_seconds"], True,
                                       device=device, t_start=t_start)
    units = (tr["trace_steps"] if tr["mode"] == "train"
             else tr["trace_protocols"])
    return result, summarize(captured[-1], tr["mode"], units)


def main(argv=None) -> int:
    from dkt_bench import run
    from dkt_bench.registry import REPO, Registry

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    t_start = run.process_start()
    for var, sub in run.CACHES:  # before CUDA is initialised
        os.environ[var] = str(REPO / ".bench_cache" / sub)
    if not torch.cuda.is_available():
        print("dkt_bench.program: needs a CUDA card", file=sys.stderr)
        return 2
    result, p = traced_cell(Registry(), args.workload, args.seed,
                            t_start=t_start)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "result": result, "program": report(p)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
