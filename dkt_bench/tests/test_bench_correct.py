"""`correct` at a size the CPU holds: sound runs of the program pass, and
the control (the reference one precision down in the program's place) and
every fault a cell can have, planted underneath the timed path, fail. The
harness's look for a card is skipped (run_cell on the CPU); the rest of a
run is driven as on the card."""
from __future__ import annotations

import pytest

from dkt_bench import calibrate, run


def _run(reg, cell, seed, law="program", fault=None):
    line = calibrate.reading(reg, cell, seed, 0.2, law=law, fault=fault,
                             device="cpu")
    return line["correct"], line["numbers"]


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_eval"])
@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_sound_run_is_correct(tiny, cell, seed):
    ok, nums = _run(tiny, cell, seed)
    assert ok, nums


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_eval"])
def test_control_is_not_correct(tiny, cell):
    for seed in (1, 2, 3):
        ok, nums = _run(tiny, cell, seed, law="control")
        assert not ok, (seed, nums)


@pytest.mark.parametrize("cell,fault,fails", [
    ("tiny_train", "unchanged", "change_gap"),
    ("tiny_train", "half_batch", "grad_gap"),
    ("tiny_train", "altered", "input_mean_diff"),
    ("tiny_train", "gp_lr", "change_gap"),
    ("tiny_eval", "altered", "post_mean_gap"),
])
def test_fault_is_not_correct(tiny, cell, fault, fails):
    ok, nums = _run(tiny, cell, 7, fault=fault)
    assert not ok
    limit = tiny.limits(cell)[fails]
    assert nums[fails] is None or nums[fails] > limit, nums


def test_faults_are_lifted(tiny):
    """A planted fault is gone once its block ends."""
    with calibrate.planted("half_batch", "train"):
        pass
    ok, nums = _run(tiny, "tiny_train", 1)
    assert ok, nums


def test_result_line_carries_the_checks_last(tiny):
    res, checks, _, _ = run.run_cell(tiny, "tiny_eval", 5, 0.2, False,
                                  device="cpu")
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(tiny.limits("tiny_eval"))
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
