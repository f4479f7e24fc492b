"""Test harness: run everything on a virtual 8-device CPU mesh.

Multi-chip sharding is validated without a pod via XLA's host-platform
device-count override (SURVEY.md §4c). Must run before jax is imported
anywhere, hence the env mutation at conftest import time.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Belt-and-braces: pytest plugins (jaxtyping) may import jax before this
# conftest runs, in which case the env mutation above is too late for the
# config defaults — set the configs explicitly too. Backends initialise
# lazily, so this works as long as no test ran yet.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_threefry_partitionable", True)

# Persistent compilation cache: the suite is compile-bound on the virtual
# CPU mesh (every jit variant recompiles from scratch otherwise).
_cache_dir = os.path.join(os.path.dirname(__file__), ".jax_cache")
# keep the CLI mains' own cache enabling (utils/jit_cache.py) pointed at
# the same directory instead of ~/.cache, so e2e tests stay warm
os.environ["DKT_JIT_CACHE"] = _cache_dir
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card (skips without one)")
