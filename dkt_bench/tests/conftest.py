"""Fixtures of the benchmark's tests: a tiny registry (a throwaway
configuration, traffic mixes, limits and BENCHMARK.json of its own, the
real metric readers) that runs on the CPU in a second, and the `chip`
marker for tests that need an NVIDIA card.

Run: python -m pytest dkt_bench/tests -q -p xdist -n 6 --dist loadfile
(on the card, the chip-marked tests run too: -m chip).
"""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH_DIR = REPO / "dkt_bench"

# Limits of the tiny cells, set between the tiny size's readings on this
# CPU over seven seeds (1-6, 2**31 + 7), sound runs against the control
# and the faults: input_mean_diff sound 0, control 0.013 to 0.015 (an
# altered image: 3.1); loss_gap sound 3.1e-4 to 1.4e-3, control 8.3e-3 to
# 1.1e-2; loss_gap_step1 sound 5.8e-6 to 8.7e-5, control 3.7e-4 to 5.2e-3;
# grad_gap sound 7.9e-4 to 1.4e-2, control 9.4e-2 to 0.21; change_gap
# (the worst leaf a step moves) sound 0.031 to 0.099, control 0.082 to
# 0.12, the GP stepped at the trunk's rate 0.37 to 0.38, a state left
# unchanged 1; bn_gap sound 1.2e-3 to 7.6e-3, control 1.1e-2 to 3.0e-2;
# posterior means equal, the control 0.069 to 0.17 off.
TINY_LIMITS = {
    "tiny_train": {"input_mean_diff": 1e-3, "loss_gap": 2e-3,
                   "loss_gap_step1": 2e-4, "grad_gap": 5e-2,
                   "change_gap": 0.2, "bn_gap": 1e-2},
    "tiny_eval": {"post_mean_gap": 1e-2},
}

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny_bench() -> dict:
    """BENCHMARK.json with its cells replaced by the two tiny ones."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": "tiny_train", "config": "tiny", "traffic": "tiny_train",
         "chips": 1, "why": "a tiny training cell for the CPU tests"},
        {"name": "tiny_eval", "config": "tiny", "traffic": "tiny_eval",
         "chips": 1, "why": "a tiny eval cell for the CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["tiny_eval"] if m["name"].endswith("eval")
                              or m["name"].startswith("eval")
                              else ["tiny_train"])
    return bench


def write_tiny(root: Path) -> Path:
    """A registry root holding the tiny configuration, mixes and limits
    beside a copy of the real metric readers."""
    shutil.copytree(BENCH_DIR / "metrics", root / "metrics")
    for d in ("configs", "traffic", "limits"):
        (root / d).mkdir()
    cfg = json.loads((BENCH_DIR / "configs" /
                      "dkt_conv4_miniimagenet.json").read_text())
    cfg.update(name="tiny", image_size=16, splits={
        "base": {"n_class": 8, "per_class": 30, "side": 18, "canvas": True},
        "novel": {"n_class": 6, "per_class": 30, "side": 16,
                  "canvas": False}})
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tiny_train.json").write_text(json.dumps(
        {"mode": "train", "n_way": 5, "n_support": 2, "n_query": 2,
         "episode_batch": 2, "split": "base", "augment": True,
         "chunk_steps": 2, "trace_steps": 2}))
    (root / "traffic" / "tiny_eval.json").write_text(json.dumps(
        {"mode": "eval", "n_way": 5, "n_support": 2, "n_query": 3,
         "episode_batch": 4, "split": "novel", "augment": False,
         "protocol_episodes": 10, "trace_protocols": 1, "check_batches": 3}))
    for cell, lim in TINY_LIMITS.items():
        (root / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    return root


@pytest.fixture
def tiny(tmp_path):
    """A Registry of the tiny cells."""
    from dkt_bench.registry import Registry

    return Registry(write_tiny(tmp_path / "bench"), copy.deepcopy(
        tiny_bench()))
