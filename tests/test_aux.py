"""Auxiliary subsystem tests: checkpoint/resume, YAML settings, metrics."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from mc_slam.camera import make_camera
from mc_slam.io import checkpoint
from mc_slam.pipeline.system import SlamConfig, SlamSystem, OK
from mc_slam.settings import load_settings
from mc_slam.utils.metrics import StageTimer, VIInitLog

from render import DotWorld

CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)


def test_checkpoint_resume(tmp_path, rng):
    """Track, checkpoint, restore into a fresh system, keep tracking."""
    import jax
    from mc_slam import lie

    world = DotWorld(rng)
    cfg = SlamConfig(max_kf=64, max_mp=2048, n_feat=384, n_levels=3,
                     min_init_matches=50)

    def pose(t):
        P = np.array([0.8 * np.sin(0.4 * t), 0.15 * np.sin(0.3 * t), 0.05 * t])
        R = np.asarray(lie.so3_exp(jnp.asarray(
            [0.0, 0.08 * np.sin(0.5 * t), 0.0], jnp.float32)))
        return P.astype(np.float32), R.astype(np.float32)

    sys1 = SlamSystem(CAM, cfg)
    for i in range(20):
        t = i * 0.1
        P, R = pose(t)
        sys1.track(world.render(R, P), t)
    assert sys1.state == OK
    ck = tmp_path / "map.npz"
    checkpoint.save_system(str(ck), sys1)

    sys2 = SlamSystem(CAM, cfg)
    checkpoint.load_system(str(ck), sys2)
    assert sys2.n_kf == sys1.n_kf
    np.testing.assert_array_equal(np.asarray(sys2.m.mp_active),
                                  np.asarray(sys1.m.mp_active))
    # resumed system tracks the continuation of the sequence
    n_ok = 0
    for i in range(20, 30):
        t = i * 0.1
        P, R = pose(t)
        n_ok += int(sys2.track(world.render(R, P), t))
    assert n_ok >= 8, n_ok


def test_settings_loader(tmp_path):
    p = tmp_path / "settings.yaml"
    p.write_text("""%YAML:1.0
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.2834
Camera.fps: 20
Camera.width: 752
Camera.height: 480
ORBextractor.nFeatures: 1000
ORBextractor.nLevels: 8
LocalMapping.LocalWindowSize: 20
test.VINSInitTime: 15.0
Camera.Tbc: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]
""")
    cam, kwargs, Tbc = load_settings(str(p))
    assert abs(float(cam.fx) - 458.654) < 1e-5
    assert kwargs["n_feat"] == 1000
    assert kwargs["local_window"] == 20
    assert Tbc is not None and Tbc.shape == (4, 4)
    np.testing.assert_allclose(Tbc[3], [0, 0, 0, 1])


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    s = t.summary()
    assert s["a"]["n"] == 2
    assert "a" in t.report()


def test_viinit_log(tmp_path):
    from mc_slam.pipeline.viinit import VIInitResult
    log = VIInitLog(str(tmp_path))
    res = VIInitResult(bg=jnp.zeros(3), ba=jnp.ones(3), scale=jnp.asarray(2.0),
                       scale_star=jnp.asarray(1.9), gw=jnp.asarray([0., 0., -9.8]),
                       Rwi=jnp.eye(3), cond=jnp.ones(6))
    log.log_attempt(1.5, res, 12.0)
    log.close()
    for f in ("scale.txt", "biasg.txt", "biasa.txt", "gw.txt", "condnum.txt",
              "computetime.txt", "Rwi.txt"):
        assert os.path.exists(tmp_path / f), f
    row = np.loadtxt(tmp_path / "scale.txt")
    np.testing.assert_allclose(row, [1.5, 2.0, 1.9])
