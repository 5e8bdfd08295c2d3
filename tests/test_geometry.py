"""Geometry tests: two-view bootstrap (general + planar scenes), DLT-PnP RANSAC
with outliers, Horn Sim3 RANSAC."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.geometry import init2view, pnp, sim3solver
from mc_slam.geometry.triangulation import triangulate_two_view

FOCAL = 400.0


def two_view_scene(rng, n=200, planar=False, noise_n=0.3 / FOCAL):
    """cam0 at origin; cam1 translated+rotated. Returns normalized obs + truth."""
    if planar:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), np.full(n, 6.0)], 1)
        pts[:, 2] += 0.3 * pts[:, 0] * 0.0  # exactly planar
    else:
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        rng.uniform(4, 10, n)], 1)
    R1 = np.asarray(lie.so3_exp(jnp.asarray([0.02, -0.15, 0.03])), np.float32)
    C1 = np.array([0.8, 0.1, 0.05], np.float32)
    xn0 = pts[:, :2] / pts[:, 2:3]
    Pc1 = (R1.T @ (pts - C1).T).T
    xn1 = Pc1[:, :2] / Pc1[:, 2:3]
    vis = (pts[:, 2] > 0.5) & (Pc1[:, 2] > 0.5)
    xn0 += rng.normal(size=xn0.shape) * noise_n
    xn1 += rng.normal(size=xn1.shape) * noise_n
    return (jnp.asarray(xn0, jnp.float32), jnp.asarray(xn1, jnp.float32),
            jnp.asarray(vis, jnp.float32), pts.astype(np.float32), R1, C1)


class TestTwoView:
    def test_general_scene(self, rng):
        xn0, xn1, w, pts, R1, C1 = two_view_scene(rng, planar=False)
        res = init2view.initialize_two_view(jax.random.PRNGKey(0), xn0, xn1, w, FOCAL)
        assert bool(res.ok)
        # direction of baseline (scale is free)
        t_est = np.asarray(res.t)
        cos = np.dot(t_est, C1) / (np.linalg.norm(t_est) * np.linalg.norm(C1))
        assert cos > 0.999, cos
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(jnp.asarray(R1.T) @ res.R)))
        assert rot_err < 0.01, rot_err
        assert int(res.n_good) > 100

    def test_planar_scene_uses_h(self, rng):
        xn0, xn1, w, pts, R1, C1 = two_view_scene(rng, planar=True)
        res = init2view.initialize_two_view(jax.random.PRNGKey(1), xn0, xn1, w, FOCAL)
        assert bool(res.used_h)  # planar -> homography wins the RH test
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(jnp.asarray(R1.T) @ res.R)))
        assert rot_err < 0.02, rot_err
        t_est = np.asarray(res.t)
        cos = np.dot(t_est, C1) / (np.linalg.norm(t_est) * np.linalg.norm(C1))
        assert cos > 0.995, cos

    def test_pure_rotation_rejected(self, rng):
        """No baseline -> no parallax -> the init must not report success."""
        n = 200
        pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                        rng.uniform(4, 10, n)], 1).astype(np.float32)
        R1 = np.asarray(lie.so3_exp(jnp.asarray([0.0, -0.2, 0.05])), np.float32)
        xn0 = pts[:, :2] / pts[:, 2:3]
        Pc1 = (R1.T @ pts.T).T
        xn1 = Pc1[:, :2] / Pc1[:, 2:3]
        xn0 += rng.normal(size=xn0.shape) * 0.3 / FOCAL
        xn1 += rng.normal(size=xn1.shape) * 0.3 / FOCAL
        res = init2view.initialize_two_view(
            jax.random.PRNGKey(2), jnp.asarray(xn0, jnp.float32),
            jnp.asarray(xn1, jnp.float32), jnp.ones(n, jnp.float32), FOCAL)
        assert not bool(res.ok)

    def test_triangulation_exact(self, rng):
        pts = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-2, 2, 50),
                        rng.uniform(3, 9, 50)], 1).astype(np.float32)
        R1 = np.asarray(lie.so3_exp(jnp.asarray([0.05, -0.1, 0.0])), np.float32)
        C1 = np.array([1.0, 0.0, 0.0], np.float32)
        xn0 = pts[:, :2] / pts[:, 2:3]
        Pc1 = (R1.T @ (pts - C1).T).T
        xn1 = Pc1[:, :2] / Pc1[:, 2:3]
        Xw, d0, d1 = triangulate_two_view(
            jnp.eye(3), jnp.zeros(3), jnp.asarray(R1), jnp.asarray(C1),
            jnp.asarray(xn0), jnp.asarray(xn1))
        np.testing.assert_allclose(np.asarray(Xw), pts, atol=1e-3)
        assert np.all(np.asarray(d0) > 0) and np.all(np.asarray(d1) > 0)


class TestPnP:
    def test_with_outliers(self, rng):
        n = 120
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                        rng.uniform(3, 9, n)], 1).astype(np.float32)
        R = np.asarray(lie.so3_exp(jnp.asarray([0.1, 0.2, -0.05])), np.float32)
        t = np.array([0.3, -0.2, 0.5], np.float32)
        Xc = (R @ pts.T).T + t
        xn = Xc[:, :2] / Xc[:, 2:3]
        xn += rng.normal(size=xn.shape) * 0.3 / FOCAL
        # 25% outliers
        n_bad = n // 4
        bad = rng.choice(n, n_bad, replace=False)
        xn[bad] += rng.uniform(0.05, 0.2, size=(n_bad, 2)) * np.sign(rng.normal(size=(n_bad, 2)))
        res = pnp.pnp_ransac(jax.random.PRNGKey(0), jnp.asarray(pts),
                             jnp.asarray(xn, jnp.float32), jnp.ones(n, jnp.float32),
                             FOCAL)
        assert bool(res.ok)
        rot_err = np.linalg.norm(np.asarray(lie.so3_log(jnp.asarray(R.T) @ res.R_cw)))
        assert rot_err < 0.02, rot_err
        np.testing.assert_allclose(np.asarray(res.t_cw), t, atol=0.05)
        # outliers not in the inlier set
        assert np.asarray(res.inliers)[bad].mean() < 0.2


class TestSim3:
    def test_horn_exact(self, rng):
        pts = rng.uniform(-2, 2, size=(30, 3)).astype(np.float32) + [0, 0, 5]
        s_true = 1.8
        R_true = np.asarray(lie.so3_exp(jnp.asarray([0.2, -0.1, 0.3])), np.float32)
        t_true = np.array([0.5, -1.0, 0.3], np.float32)
        Pb = s_true * (R_true @ pts.T).T + t_true
        s, R, t = sim3solver.horn_sim3(jnp.asarray(pts), jnp.asarray(Pb))
        np.testing.assert_allclose(float(s), s_true, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-3)

    def test_ransac_with_outliers(self, rng):
        n = 80
        pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32) + [0, 0, 6]
        s_true = 0.7
        R_true = np.asarray(lie.so3_exp(jnp.asarray([-0.1, 0.25, 0.1])), np.float32)
        t_true = np.array([1.0, 0.2, -0.4], np.float32)
        Pb = s_true * (R_true @ pts.T).T + t_true
        bad = rng.choice(n, n // 4, replace=False)
        Pb[bad] += rng.uniform(0.5, 2.0, size=(len(bad), 3))
        res = sim3solver.sim3_ransac(jax.random.PRNGKey(0), jnp.asarray(pts),
                                     jnp.asarray(Pb), jnp.ones(n, jnp.float32), FOCAL)
        assert bool(res.ok)
        np.testing.assert_allclose(float(res.s), s_true, rtol=0.02)
        np.testing.assert_allclose(np.asarray(res.t), t_true, atol=0.05)

    def test_fix_scale(self, rng):
        pts = rng.uniform(-2, 2, size=(40, 3)).astype(np.float32) + [0, 0, 6]
        R_true = np.asarray(lie.so3_exp(jnp.asarray([0.1, 0.1, -0.2])), np.float32)
        t_true = np.array([0.3, 0.4, 0.1], np.float32)
        Pb = (R_true @ pts.T).T + t_true
        res = sim3solver.sim3_ransac(jax.random.PRNGKey(0), jnp.asarray(pts),
                                     jnp.asarray(Pb), jnp.ones(40, jnp.float32),
                                     FOCAL, fix_scale=True)
        assert float(res.s) == 1.0
        np.testing.assert_allclose(np.asarray(res.t), t_true, atol=1e-3)
