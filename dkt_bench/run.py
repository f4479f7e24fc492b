"""The benchmark of deep_kernel_transfer_tpu_torch, one cell a process:

    python3 -m dkt_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up draws the cell's split and weights on the card from the seed,
builds the program's DKT, and drives its first three steps (or one eval
protocol) through the window's own feed and call; the window then runs
steps (or 600-episode protocols) back to back for `--seconds`. With
`--trace 1` a few steps (or one protocol) run under torch.profiler
instead and the per-layer metrics are read from the trace. After the
window the program is freed and the plain reference (reference/) decides
`correct`. The last line of standard output is one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from dkt_bench import check, trace
from dkt_bench.reference import dkt as ref
from dkt_bench.reference.common import mix
from dkt_bench.registry import REPO, Registry

CHECK_STEPS = 3  # training steps the reference follows
EXACT_EPISODES = 2  # of the first batch, for the float64 gradient that
# decides which leaves a step moves (check.py, change_gap)
# every build and kernel cache at a fixed path inside the checkout (the
# port builds its CUDA library into its own package's _build/)
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
          ("CUDA_CACHE_PATH", "cuda"))
FORBIDDEN = {"jax", "jaxlib", "flax", "deep_kernel_transfer_tpu"}
# seed streams (reference.common.mix)
SPLIT, FEED, WEIGHTS, WARM, PROTOCOL = 1, 2, 3, 4, 100


def process_start() -> float:
    """The process's start on the host clock (from /proc; to 10 ms)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Marks:
    """Points on the card's stream (CUDA events), or on the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.points: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.points.append(e)
        else:
            self.points.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        """ms between consecutive marks (after a sync)."""
        p = self.points
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(p, p[1:])]
        return [(b - a) * 1e3 for a, b in zip(p, p[1:])]


class Laps:
    """Seconds of each named phase of set-up, on the host clock."""

    def __init__(self, t0: float):
        self.t, self.laps = t0, {}

    def __call__(self, name: str) -> None:
        now = time.time()
        self.laps[name] = now - self.t
        self.t = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, stream))


def dataset(split: dict, canvas: bool):
    """The port's DeviceDataset over a split already on the card (its
    constructor stages from files)."""
    from deep_kernel_transfer_tpu_torch.data.device_dataset import \
        DeviceDataset

    ds = DeviceDataset.__new__(DeviceDataset)
    ds.device = split["images"].device
    ds.canvas, ds.mesh = canvas, None
    ds.images, ds.table, ds.counts = (split["images"], split["table"],
                                      split["counts"])
    return ds


def build_model(cfg: dict, tr: dict, weights: dict, device):
    """The port's DKT for the configuration, holding `weights`."""
    from deep_kernel_transfer_tpu_torch.methods.dkt import DKT
    from deep_kernel_transfer_tpu_torch.models.backbones import model_dict

    model = DKT(model_dict[cfg["model"]](), tr["n_way"], tr["n_support"],
                kernel_type=cfg["kernel_type"], gp_lr=cfg["gp_lr"],
                feature_lr=cfg["feature_lr"], noise=cfg["gp_noise"],
                feature_dtype=cfg["precision"]["trunk"], device=device)
    size = cfg["image_size"]
    model.init(torch.zeros((tr["n_way"], tr["n_support"] + tr["n_query"],
                            size, size, 3), dtype=torch.uint8))
    model.load_state_dict(weights, strict=True)
    model.reset_opt_state()
    return model


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def quantile(values: list[float], q: float) -> float:
    """The q-quantile, interpolating between order statistics."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def traced(device, fn):
    """Run fn() under torch.profiler (the card's activity too on CUDA)
    and return the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        with trace.span("window"):
            fn()
        sync(device)
    return trace.profiler_events(prof)


# ------------------------------------------------------------- training


def train_cell(cfg, tr, seed, seconds, traced_run, device, law, t_start,
               lap):
    """(end-to-end metrics, trace record or None, attempted, failed,
    peak bytes, numbers, worst leaves)."""
    from deep_kernel_transfer_tpu_torch.data.device_dataset import \
        make_fused_epoch

    w, b = tr["n_way"], tr["episode_batch"]
    split_spec = cfg["splits"][tr["split"]]
    lap("start")
    split = ref.make_split(split_spec, generator(device, seed, SPLIT), device)
    weights0 = ref.draw_weights(cfg, w, generator(device, seed, WEIGHTS),
                                device)
    sync(device)
    lap("split_and_weights")
    model = build_model(cfg, tr, weights0, device)
    ds = dataset(split, split_spec["canvas"])
    del split
    weights0 = {k: v.cpu() for k, v in weights0.items()}  # the reference's
    lap("model")
    names = dict(model.named_parameters())
    ctx = SimpleNamespace(keep=False, inputs=[], grad1=None, marks=None)
    beta1 = model.optimizer.param_groups[0]["betas"][0]

    def step(x):
        with trace.span("train_step"):
            m = model.train_step(x)
        if ctx.marks is not None:
            ctx.marks.mark()
        if ctx.keep:
            ctx.inputs.append(x.to("cpu", copy=True))
            if ctx.grad1 is None:  # the gradient as Adam holds it
                st = model.optimizer.state
                ctx.grad1 = {n: (st[p]["exp_avg"] / (1 - beta1)).cpu()
                             if "exp_avg" in st.get(p, {}) else None
                             for n, p in names.items()}
        return m

    chunk = make_fused_epoch(model, ds, w, tr["n_support"], tr["n_query"], b,
                             augment_to=cfg["image_size"] if tr["augment"]
                             else None, step=step)
    gen = generator(device, seed, FEED)
    ctx.keep = True
    with trace.span("chunk"):
        ms, _ = chunk(gen, CHECK_STEPS)
    ctx.keep = False
    lap("first_steps")
    prog = {"inputs": ctx.inputs, "losses": ms["loss"].tolist(),
            "grad1": ctx.grad1,
            "params": {k: v.detach().to("cpu", copy=True)
                       for k, v in model.state_dict().items()}}
    sync(device)
    lap("snapshot")
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    e2e, record = {}, None
    attempted = failed = 0
    if traced_run:
        def window():
            with trace.span("chunk"):
                chunk(gen, tr["trace_steps"])

        record = trace.summarize(traced(device, window), "train", cfg, tr,
                                 tr["trace_steps"])
        attempted = tr["trace_steps"] * b
    else:
        marks = Marks(device)
        ctx.marks = marks
        losses = []
        marks.mark()
        host0 = time.perf_counter()
        while True:
            with trace.span("chunk"):
                ms, _ = chunk(gen, tr["chunk_steps"])
            losses.append(ms["loss"])
            if time.perf_counter() - host0 >= seconds:
                break
        sync(device)
        ctx.marks = None
        steps_ms = marks.intervals_ms()
        window_s = sum(steps_ms) / 1e3
        attempted = len(steps_ms) * b
        failed = b * int((~torch.isfinite(torch.cat(losses))).sum())
        e2e = {"train_episodes_per_s": attempted / window_s,
               "train_step_p90_ms": quantile(steps_ms, 0.9),
               "setup_s": setup_s}
    peak = 0
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, window_peak)
        e2e["peak_mem_gib"] = window_peak / 2 ** 30
    # the program's state is freed before the reference runs
    del model, ds, chunk, gen, names, ctx, ms
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    split = ref.make_split(split_spec, generator(device, seed, SPLIT), device)
    feed = mix(seed, FEED)
    on_card = {k: v.to(device) for k, v in weights0.items()}
    reference = ref.train_steps(cfg, tr, on_card, split, feed, CHECK_STEPS,
                                exact_episodes=EXACT_EPISODES)
    if law in ("control", "onepass"):  # the reference in the program's place
        prog = ref.train_steps(cfg, tr, on_card, split, feed, CHECK_STEPS,
                               law=law)
    nums, where = check.train_numbers(prog, reference, weights0,
                                      ref.trainable(cfg, w))
    return e2e, record, attempted, failed, peak, nums, where


# ----------------------------------------------------------------- eval


def eval_cell(cfg, tr, seed, seconds, traced_run, device, law, t_start,
               lap):
    from deep_kernel_transfer_tpu_torch.data.device_dataset import (
        fused_protocol_accs, make_fused_eval)
    from deep_kernel_transfer_tpu_torch.methods.base import query_accuracy

    w, b = tr["n_way"], tr["episode_batch"]
    split_spec = cfg["splits"][tr["split"]]
    lap("start")
    split = ref.make_split(split_spec, generator(device, seed, SPLIT), device)
    weights = ref.draw_weights(cfg, w, generator(device, seed, WEIGHTS),
                               device, trained=True)
    sync(device)
    lap("split_and_weights")
    model = build_model(cfg, tr, weights, device)
    ds = dataset(split, split_spec["canvas"])
    del split
    weights = {k: v.cpu() for k, v in weights.items()}  # the reference's
    lap("model")
    ctx = SimpleNamespace(protocol=None, batch=0, wanted=set(), kept={})

    def correct(xb):
        with trace.span("eval_batch"), torch.no_grad():
            logits = model.batch_logits(xb)
            key = (ctx.protocol, ctx.batch)
            ctx.batch += 1
            if key in ctx.wanted:
                ctx.kept[key] = logits
            return query_accuracy(torch.argmax(torch.sigmoid(logits), dim=-1),
                                  xb.shape[1])

    eval_chunk = make_fused_eval(model, ds, w, tr["n_support"], tr["n_query"],
                                 b, correct)
    n_ep = tr["protocol_episodes"]

    def protocol(p: int) -> torch.Tensor:
        ctx.protocol, ctx.batch = p, 0
        gen = generator(device, seed, PROTOCOL + p if p >= 0 else WARM)
        with trace.span("protocol"):
            accs = fused_protocol_accs(eval_chunk, gen, n_ep, b)
        with trace.span("readback"):
            return accs.cpu()

    protocol(-1)  # warms every shape: the full batches and the last
    lap("first_protocol")
    t = time.perf_counter()
    protocol(-1)
    t_protocol = time.perf_counter() - t
    lap("second_protocol")
    # a sample drawn from the seed of the batches of protocols sure to
    # complete in the window, the short last batch among them
    n_batches = -(-n_ep // b)
    sure = (tr["trace_protocols"] if traced_run
            else max(1, int(0.5 * seconds / t_protocol)))
    rng = random.Random(mix(seed, 5))
    cells = [(p, j) for p in range(sure) for j in range(n_batches)]
    wanted = {(rng.randrange(sure), n_batches - 1)}
    while len(wanted) < min(tr["check_batches"], len(cells)):
        wanted.add(rng.choice(cells))
    ctx.wanted = wanted
    sync(device)
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    e2e, record = {}, None
    failed = 0
    if traced_run:
        def window():
            for p in range(tr["trace_protocols"]):
                protocol(p)

        record = trace.summarize(traced(device, window), "eval", cfg, tr,
                                 tr["trace_protocols"])
        attempted = tr["trace_protocols"] * n_ep
    else:
        marks = Marks(device)
        marks.mark()
        host0 = time.perf_counter()
        done = 0
        while True:
            accs = protocol(done)
            marks.mark()
            done += 1
            failed += int((~torch.isfinite(accs)).sum())
            if time.perf_counter() - host0 >= seconds:
                break
        sync(device)
        window_s = sum(marks.intervals_ms()) / 1e3
        attempted = done * n_ep
        e2e = {"eval_episodes_per_s": attempted / window_s, "setup_s": setup_s}
    peak = 0
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
        peak = max(setup_peak, window_peak)
        e2e["peak_mem_gib"] = window_peak / 2 ** 30
    prog = {k: v.cpu() for k, v in ctx.kept.items()}
    del model, ds, eval_chunk, ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    split = ref.make_split(split_spec, generator(device, seed, SPLIT), device)
    weights = {k: v.to(device) for k, v in weights.items()}
    reference, control = {}, {}
    for p in sorted({p for p, _ in wanted}):
        js = [j for q, j in wanted if q == p]
        for j, v in ref.eval_means(cfg, tr, weights, split,
                                   mix(seed, PROTOCOL + p), js).items():
            reference[(p, j)] = v
        if law == "control":
            for j, v in ref.eval_means(cfg, tr, weights, split,
                                       mix(seed, PROTOCOL + p), js,
                                       law="control").items():
                control[(p, j)] = v
    nums, where = check.eval_numbers(control if law == "control" else prog,
                                     reference)
    return e2e, record, attempted, failed, peak, nums, where


def run_cell(reg: Registry, name: str, seed: int, seconds: float,
             traced_run: bool, device="cuda", law: str = "program",
             t_start: float | None = None):
    """One run of the cell. Returns (the result line's dict, the numbers
    compared with their limits, each number's worst leaf or batch, every
    number read).
    law="control" puts the reference, one precision down, in the
    program's place for the comparison (the program still runs); in a
    training cell law="onepass" puts there the reference with the
    program's one-pass BatchNorm variance, the witness of round-off
    (reference/common.py)."""
    t_start = time.time() if t_start is None else t_start
    device = torch.device(device)
    cell = reg.cell(name)
    cfg, tr = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    limits = reg.limits(name)
    run = train_cell if tr["mode"] == "train" else eval_cell
    lap = Laps(t_start)
    e2e, record, attempted, failed, peak, nums, where = run(
        cfg, tr, seed, seconds, traced_run, device, law, t_start, lap)
    ok, checks = check.judge(nums, limits)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": int(peak),
               "power_limit": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": cell["chips"],
               "memory_peak_bytes": 0}
    metrics = {}
    if traced_run:
        for m in reg.metrics(name, "per_layer"):
            v = reg.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = record.busy_s, record.window_s
    else:
        for m in reg.metrics(name, "end_to_end"):
            value = e2e.get(m["name"])
            if value is not None:  # no memory reading on the CPU
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced_run:
        result["breakdown"] = {"device_ops": record.device_ops,
                               "idle_gaps": record.idle_gaps}
    result["setup_phases_s"] = lap.laps
    result["checks"] = {k: {"value": _json_num(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    return result, checks, where, nums


def _json_num(v: float):
    return v if math.isfinite(v) else None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    for var, sub in CACHES:  # before the driver is initialised
        os.environ[var] = str(REPO / ".bench_cache" / sub)
    reg = Registry()
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"dkt_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result, checks, where, nums = run_cell(reg, args.workload, args.seed,
                                           args.seconds, bool(args.trace),
                                           t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"dkt_bench: the process loaded {', '.join(found)}; the "
              "benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']}: failed {result['failed']} of "
          f"{result['attempted']} attempted; set-up phases (s) "
          f"{json.dumps(result['setup_phases_s'])}", file=sys.stderr)
    for k, v in nums.items():
        if k not in checks:
            print(f"read {k} {v!r}, not compared (worst: "
                  f"{where.get(k, '-')})", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"(worst: {where.get(k, '-')})", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
