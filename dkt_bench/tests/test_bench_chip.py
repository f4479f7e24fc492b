"""On the card: one short run of a cell through the command, and the
control at the cell's own size coming out not correct."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO
from dkt_bench import calibrate
from dkt_bench.registry import Registry

pytestmark = pytest.mark.chip


def test_command_on_the_card(card):
    out = subprocess.run([sys.executable, "-m", "dkt_bench.run", "--workload",
                          "conv4_mini_eval_b32", "--seed", "3100000001",
                          "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["metrics"]["eval_episodes_per_s"]["value"] > 0


def test_control_fails_at_the_cells_size(card):
    line = calibrate.reading(Registry(), "conv4_mini_eval_b32", 3100000002,
                             2.0, law="control")
    assert not line["correct"], line["numbers"]
