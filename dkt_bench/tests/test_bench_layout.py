"""BENCHMARK.json against the benchmark's files and the contract's shapes,
the registry's lookups by name, the result line, and the check that
nothing under dkt_bench/ imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, REPO, tiny_bench, write_tiny
from dkt_bench import run
from dkt_bench.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "deep_kernel_transfer_tpu"}
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dkt_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    assert all(NAME.match(n) for n in names), names
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys_and_bounds():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_every_cell_finds_its_files():
    reg = Registry()
    for w in BENCH["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["name"] == w["config"]
        assert reg.traffic(w["traffic"])["mode"] in ("train", "eval")
        assert reg.limits(w["name"])
        e2e = {m["name"] for m in reg.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = reg.metrics(w["name"], "per_layer")
        assert layer
        for m in layer:  # each moves a metric the cell reports
            assert m["moves"] in e2e
            assert callable(reg.reader(m["name"]))


def test_config_files_state_the_cut():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_a_configuration_is_added_as_a_file_only(tmp_path):
    """A throwaway configuration and cell, new files and a new entry:
    the harness finds and runs them with no file of its own changed."""
    root = write_tiny(tmp_path / "bench")
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["name"] = "throwaway"
    (root / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    (root / "limits" / "throwaway_eval.json").write_text(
        (root / "limits" / "tiny_eval.json").read_text())
    bench = tiny_bench()
    bench["workloads"].append({"name": "throwaway_eval", "config":
                               "throwaway", "traffic": "tiny_eval",
                               "chips": 1, "why": "added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny_eval" in m.get("workloads", []):
            m["workloads"].append("throwaway_eval")
    reg = Registry(root, bench)
    res, _, _, _ = run.run_cell(reg, "throwaway_eval", 3, 0.2, False,
                             device="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"eval_episodes_per_s", "setup_s"}
    with pytest.raises(KeyError):
        reg.config("absent")


def test_result_line_keys(tiny):
    res, _, _, _ = run.run_cell(tiny, "tiny_train", 2, 0.2, True, device="cpu")
    assert {"correct", "attempted", "failed", "metrics", "device",
            "breakdown"} <= set(res)
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(res)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_module_imports_jax_or_the_jax_package():
    """By whole top-level name: deep_kernel_transfer_tpu_torch begins with
    the JAX package's name and is allowed."""
    files = sorted(BENCH_DIR.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    assert "deep_kernel_transfer_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """A whole run in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys, torch; sys.path.insert(0, 'dkt_bench/tests');"
        "from conftest import tiny_bench, write_tiny;"
        "import tempfile, pathlib;"
        "from dkt_bench import run; from dkt_bench.registry import Registry;"
        "torch.set_num_threads(2);"
        "root = write_tiny(pathlib.Path(tempfile.mkdtemp()) / 'b');"
        "res, _, _, _ = run.run_cell(Registry(root, tiny_bench()), 'tiny_train',"
        " 4, 0.2, False, device='cpu');"
        "print(res['correct'], run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_no_card_means_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    if run.torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "dkt_bench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed",
                          "3000000000", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deep_kernel_transfer_tpu_torch_x",
                        object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
