"""Test config: force an 8-device virtual CPU mesh before any JAX computation.

The suite runs on the CPU: multi-device sharding (shard_map) is validated on
virtual CPU devices. Tests that need a GPU carry the `gpu` marker and take
the `gpu_device` fixture, which skips them when JAX finds no GPU; GPU
measurements live in chip_smoke.py and bench.py.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

# GPU tests share the card with nothing else, but several test processes
# must not each reserve three quarters of it
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import jax  # noqa: E402

# CPU first: every test runs on the CPU unless it asks for the GPU through
# the gpu_device fixture (CUDA is absent or skipped where there is no card)
jax.config.update("jax_platforms", "cpu,cuda")
# The persistent compilation cache is DISABLED by default (also when
# JAX_COMPILATION_CACHE_DIR is set for the GPU scripts): on this machine the
# XLA:CPU executable (de)serialization path crashed the suite repeatedly
# (SIGSEGV in get_executable_and_time, SIGABRT in put_executable_and_time,
# machine-feature-mismatch SIGILL warnings) — even with
# jax_persistent_cache_enable_xla_caches="none" and a freshly purged cache.
# Opt back in with JAX_TEST_CACHE_DIR=/path if the host is known-good.
_cache_dir = os.environ.get("JAX_TEST_CACHE_DIR", "")
jax.config.update("jax_enable_compilation_cache", bool(_cache_dir))
if _cache_dir:
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    # persist every executable (see eval_clone.py on the sub-second floor)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    except Exception:
        pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX finds none. Decided here, at run
    time, never at import: xdist workers must all collect the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
    return devs[0]
