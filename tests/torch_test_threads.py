"""The thread policy of the port's test modules. Every tests/test_torch_*.py
but test_torch_import.py (the JAX package's own) imports its fixture in one
line:

    from torch_test_threads import one_thread  # noqa: F401

The suite runs several test processes side by side, and in each of them
numpy's BLAS pool and torch's OpenMP pool start with a thread a core, so
that together they oversubscribe the machine many times over. For the
duration of a port module the autouse fixture holds every BLAS and OpenMP
pool of the process (threadpoolctl) and torch's intra-op pool to one
thread, and sets OMP_NUM_THREADS, OPENBLAS_NUM_THREADS and MKL_NUM_THREADS
to 1 so that child processes start with one thread too. It restores all of
them afterwards, so a module of the JAX package that runs next in the same
process sees what it saw before.
"""
from __future__ import annotations

import pytest
import torch
from threadpoolctl import threadpool_limits

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    with threadpool_limits(1), pytest.MonkeyPatch.context() as mp:
        for name in THREAD_VARS:
            mp.setenv(name, "1")
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)
