"""Process set-up shared by the GPU scripts (mc_slam.runtime): the device
check, the compile-cache placement and the smoke run's last line."""
import json
import os

import jax
import pytest

from mc_slam import runtime


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu(jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu([])


@pytest.mark.parametrize("env,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
    ({}, os.path.join(runtime.CHECKOUT, ".jax_cache")),
])
def test_compile_cache_dir(env, expected):
    assert runtime.compile_cache_dir(env) == expected


def test_cache_dir_is_git_ignored():
    with open(os.path.join(runtime.CHECKOUT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_result_line_shape():
    line = runtime.result_line(jax.devices("cpu"))
    assert "\n" not in line
    d = json.loads(line)
    assert d == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                        "count": len(jax.devices("cpu"))}}
    assert list(d) == ["ok", "device"]
    assert list(d["device"]) == ["platform", "kind", "count"]
