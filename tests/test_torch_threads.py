"""The thread policy of the port's test modules (tests/torch_test_threads.py):
every port test module imports the shared fixture, and inside one the
process runs torch, every BLAS and OpenMP pool and its children's pools on
one thread."""
from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest
import torch
from threadpoolctl import threadpool_info

from torch_test_threads import THREAD_VARS
from torch_test_threads import one_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
PORT_MODULES = sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(HERE,
                                                        "test_torch_*.py"))
    if os.path.basename(p) != "test_torch_import.py")  # the JAX package's


@pytest.mark.parametrize("name", PORT_MODULES)
def test_port_module_imports_the_thread_fixture(name):
    with open(os.path.join(HERE, name)) as f:
        tree = ast.parse(f.read())
    assert any(isinstance(node, ast.ImportFrom)
               and node.module == "torch_test_threads"
               and "one_thread" in [a.name for a in node.names]
               for node in tree.body), name


def test_a_port_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
    pools = threadpool_info()
    assert {p["user_api"] for p in pools} >= {"blas", "openmp"}
    assert [p["num_threads"] for p in pools] == [1] * len(pools), pools
    assert [os.environ.get(k) for k in THREAD_VARS] == ["1"] * len(THREAD_VARS)


def test_a_child_process_starts_on_one_thread():
    code = ("import json, numpy, torch, threadpoolctl; print(json.dumps("
            "[torch.get_num_threads()] + [p['num_threads'] for p in "
            "threadpoolctl.threadpool_info()]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    threads = json.loads(out.stdout.splitlines()[-1])
    assert len(threads) >= 3 and set(threads) == {1}, threads
