"""Process set-up shared by the scripts that run on the GPU (chip_smoke.py,
bench.py, examples/eval_clone.py, eval_vocab.py, bench_scaling.py): where the
persistent compile cache lives, which device a measurement runs on, and the
line that names it.

A measurement never falls back to the CPU: `use_gpu` puts CUDA first before
any device is touched and fails when the first device is not a GPU.
"""
from __future__ import annotations

import json
import os

CHECKOUT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# fixed in-checkout path: the cache key includes the directory, so a path
# that moves between runs never hits (listed in .gitignore)
CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def compile_cache_dir(environ=None):
    """The directory this process must set for the compile cache, or None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself)."""
    environ = os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def setup_compile_cache():
    """Place the persistent compile cache and persist every executable (a
    pipeline run makes hundreds of sub-second compiles, which the default
    one-second floor would pay again on every run). Returns the directory in
    use."""
    import jax
    d = compile_cache_dir()
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return d or os.environ["JAX_COMPILATION_CACHE_DIR"]


def require_gpu(devices):
    """The first device, after checking that it is a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(f"no GPU: JAX's first device is {found!r}")
    return devices[0]


def use_gpu():
    """Make CUDA JAX's default platform (call before anything touches a
    device) and return the first device. The CPU backend stays reachable
    through jax.devices("cpu") for reference comparisons; JAX itself would
    fall back to it silently when CUDA fails to start, so this raises unless
    the first device is a GPU."""
    import jax
    jax.config.update("jax_platforms", "cuda,cpu")
    return require_gpu(jax.devices())


def device_info(devices):
    """{"platform", "kind", "count"} as JAX reports the devices."""
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def result_line(devices):
    """The last line a successful smoke run prints."""
    return json.dumps({"ok": True, "device": device_info(devices)})
