"""Find the benchmark's cells, configurations, traffic mixes, limits and
per-layer metric readers by name.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own under the benchmark's folder:

    configs/<config>.json     model, precision law, dataset layout, source
    traffic/<mix>.json        mode, episode shape, batch, split, window
    limits/<cell>.json        the limit of each number `correct` compares
    metrics/<metric>.py       read(record) -> value or None

and BENCHMARK.json at the repository root names the cells and metrics. A
new cell, configuration, mix or metric is new files plus new entries; no
file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


class Registry:
    """The benchmark's files under `root`, and BENCHMARK.json (a path, or
    the parsed dict itself)."""

    def __init__(self, root: Path | str = HERE, bench=None):
        self.root = Path(root)
        if bench is None:
            bench = REPO / "BENCHMARK.json"
        if not isinstance(bench, dict):
            bench = json.loads(Path(bench).read_text())
        self.bench = bench
        self._readers: dict = {}

    def _json(self, kind: str, name: str) -> dict:
        path = self.root / kind / f"{name}.json"
        if not path.exists():
            raise KeyError(f"no {kind[:-1]} named {name!r} ({path})")
        return json.loads(path.read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload named {name!r}")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The `kind` ("end_to_end" or "per_layer") metrics the cell
        reports: those that list it, or, without a `workloads` key, every
        end-to-end metric, and every per-layer metric whose `moves` the
        cell reports."""
        if kind == "end_to_end":
            return [m for m in self.bench["end_to_end"]
                    if cell in m.get("workloads", [cell])]
        moved = {m["name"] for m in self.metrics(cell, "end_to_end")}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """metrics/<metric>.py's `read`, loaded from its path (a metric's
        name may hold dots)."""
        if metric not in self._readers:
            path = self.root / "metrics" / f"{metric}.py"
            if not path.exists():
                raise KeyError(f"no reader for metric {metric!r} ({path})")
            spec = importlib.util.spec_from_file_location(
                "dkt_bench_metric_" + metric.replace(".", "_"), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._readers[metric] = module.read
        return self._readers[metric]
