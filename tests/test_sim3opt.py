"""OptimizeSim3-parity tests + localization-only mode."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.camera import make_camera
from mc_slam.solver.sim3opt import optimize_sim3

CAM = make_camera(400.0, 400.0, 320.0, 240.0)


def test_sim3_pixel_refinement(rng):
    """Noisy Horn-style init must converge to the true relative Sim3 using
    pixel observations in both frames."""
    n = 60
    Pc1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    s_t = 1.4
    R_t = np.asarray(lie.so3_exp(jnp.asarray([0.1, -0.2, 0.15])), np.float32)
    t_t = np.array([0.4, -0.2, 0.3], np.float32)
    # S12 maps cam2 -> cam1: Pc1 = s R Pc2 + t  =>  Pc2 = S21(Pc1)
    Rt = R_t.T
    Pc2 = (Rt @ (Pc1 - t_t).T).T / s_t
    uv1 = np.stack([400 * Pc1[:, 0] / Pc1[:, 2] + 320,
                    400 * Pc1[:, 1] / Pc1[:, 2] + 240], 1)
    uv2 = np.stack([400 * Pc2[:, 0] / Pc2[:, 2] + 320,
                    400 * Pc2[:, 1] / Pc2[:, 2] + 240], 1)
    uv1 += rng.normal(size=uv1.shape) * 0.3
    uv2 += rng.normal(size=uv2.shape) * 0.3
    # perturbed init
    s0 = jnp.asarray(s_t * 1.15)
    R0 = jnp.asarray(R_t) @ lie.so3_exp(jnp.asarray([0.03, -0.02, 0.04]))
    t0 = jnp.asarray(t_t + np.asarray([0.1, -0.05, 0.08], np.float32))
    s, R, t, n_in = optimize_sim3(
        s0, R0, t0, jnp.asarray(Pc1), jnp.asarray(Pc2),
        jnp.asarray(uv1, jnp.float32), jnp.asarray(uv2, jnp.float32),
        jnp.ones(n), CAM, iters=20)
    assert abs(float(s) - s_t) < 0.02, float(s)
    rot_err = np.linalg.norm(np.asarray(lie.so3_log(jnp.asarray(R_t.T) @ R)))
    assert rot_err < 0.01, rot_err
    np.testing.assert_allclose(np.asarray(t), t_t, atol=0.05)
    assert int(n_in) > 0.9 * n


def test_sim3_outlier_gating(rng):
    n = 50
    Pc1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 9, n)], 1).astype(np.float32)
    Pc2 = Pc1.copy()
    uv1 = np.stack([400 * Pc1[:, 0] / Pc1[:, 2] + 320,
                    400 * Pc1[:, 1] / Pc1[:, 2] + 240], 1).astype(np.float32)
    uv2 = uv1.copy()
    bad = rng.choice(n, 10, replace=False)
    uv2[bad] += 50.0
    s, R, t, n_in = optimize_sim3(
        jnp.asarray(1.0), jnp.eye(3), jnp.zeros(3),
        jnp.asarray(Pc1), jnp.asarray(Pc2), jnp.asarray(uv1), jnp.asarray(uv2),
        jnp.ones(n), CAM, iters=10)
    assert int(n_in) == n - 10
    np.testing.assert_allclose(float(s), 1.0, atol=0.01)


def test_localization_only_mode(rng):
    import sys as _s
    _s.path.insert(0, "tests")
    from render import DotWorld
    from mc_slam.pipeline.system import SlamConfig, SlamSystem, OK
    cam = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
    world = DotWorld(rng)
    cfg = SlamConfig(max_kf=64, max_mp=2048, n_feat=384, n_levels=3,
                     min_init_matches=50)
    sys = SlamSystem(cam, cfg)

    def pose(t):
        P = np.array([0.8 * np.sin(0.4 * t), 0.1 * np.sin(0.3 * t), 0.0], np.float32)
        return P, np.eye(3, dtype=np.float32)

    for i in range(15):
        t = i * 0.1
        P, R = pose(t)
        sys.track(world.render(R, P), t)
    n_kf_before = sys.n_kf
    sys.set_localization_mode(True)
    n_ok = 0
    for i in range(15, 25):
        t = i * 0.1
        P, R = pose(t)
        n_ok += int(sys.track(world.render(R, P), t))
    assert n_ok >= 8
    assert sys.n_kf == n_kf_before  # frozen map: no new keyframes
