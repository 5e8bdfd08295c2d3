"""Shared synthetic VI-SLAM world generator for tests.

Produces an analytic smooth trajectory with exact IMU samples (gyro/accel with
optional bias + noise), keyframe camera poses, a landmark cloud, and pixel
observations — the test-pyramid replacement for the reference's dataset-run
testing (SURVEY.md section 4).
"""
import numpy as np
import jax.numpy as jnp

from mc_slam import lie

G = 9.81
GW = np.array([0.0, 0.0, -G])


def _rodrigues(v):
    v = np.asarray(v, np.float64)
    th = np.linalg.norm(v)
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rot_from_rpy(r, p, y):
    return _rodrigues([r, 0, 0]) @ _rodrigues([0, p, 0]) @ _rodrigues([0, 0, y])


class Trajectory:
    """P(t), R(t) analytic; derivatives by central differences at fine dt."""

    def __init__(self, kind="arc", speed=1.0):
        self.kind = kind
        self.speed = speed

    def pose(self, t):
        s = self.speed
        if self.kind == "arc":
            P = np.array([2.0 * np.sin(0.5 * s * t),
                          2.0 * np.cos(0.5 * s * t) - 2.0,
                          0.3 * np.sin(0.9 * s * t)])
            R = _rot_from_rpy(0.12 * np.sin(0.7 * s * t),
                              0.10 * np.sin(0.9 * s * t + 1.0),
                              0.5 * s * t * 0.4)
        elif self.kind == "gentle":
            # faces +z (a wall scene) with MAV-like acceleration excitation AND
            # strong roll about the optical axis: rotation is what separates
            # gravity from accel bias in VI init (rank of eq. 19/20's C matrix)
            P = np.array([1.1 * np.sin(1.2 * s * t),
                          0.35 * np.sin(1.7 * s * t),
                          0.18 * np.sin(1.1 * s * t)])
            R = _rot_from_rpy(0.04 * np.sin(0.9 * t), 0.08 * np.sin(0.5 * t),
                              0.5 * np.sin(0.9 * t))
        elif self.kind == "line":
            P = np.array([s * t, 0.02 * np.sin(3 * t), 0.0])
            R = _rot_from_rpy(0.05 * np.sin(2 * t), 0.04 * np.cos(1.5 * t), 0.02 * t)
        else:
            raise ValueError(self.kind)
        return P, R

    def velocity(self, t, eps=1e-4):
        P1, _ = self.pose(t - eps)
        P2, _ = self.pose(t + eps)
        return (P2 - P1) / (2 * eps)

    def accel(self, t, eps=1e-3):
        P0, _ = self.pose(t - eps)
        P1, _ = self.pose(t)
        P2, _ = self.pose(t + eps)
        return (P2 - 2 * P1 + P0) / (eps * eps)

    def omega_body(self, t, eps=1e-4):
        _, R1 = self.pose(t - eps)
        _, R2 = self.pose(t + eps)
        return np.asarray(lie.so3_log(jnp.asarray(R1.T @ R2))) / (2 * eps)

    def imu_samples(self, t0, t1, rate=200.0, bg=np.zeros(3), ba=np.zeros(3),
                    noise_g=0.0, noise_a=0.0, rng=None):
        """(T, 7) float32 [omega_meas, acc_meas, dt] rows covering [t0, t1)."""
        dt = 1.0 / rate
        ts = np.arange(t0, t1 - 1e-9, dt)
        rows = np.zeros((len(ts), 7), np.float64)
        for k, t in enumerate(ts):
            tm = t + 0.5 * dt  # midpoint sampling: closer to piecewise-constant truth
            _, R = self.pose(tm)
            a_w = self.accel(tm)
            rows[k, 0:3] = self.omega_body(tm) + bg
            rows[k, 3:6] = R.T @ (a_w - GW) + ba
            rows[k, 6] = dt
        if rng is not None and (noise_g > 0 or noise_a > 0):
            rows[:, 0:3] += rng.normal(size=(len(ts), 3)) * noise_g
            rows[:, 3:6] += rng.normal(size=(len(ts), 3)) * noise_a
        return rows.astype(np.float32)


def make_landmarks(rng, n=300, center=(0.0, -2.0, 0.0), spread=6.0, zoff=5.0):
    """Cloud of points in front of the arc trajectory."""
    pts = rng.uniform(-spread, spread, size=(n, 3))
    pts += np.asarray(center)
    pts[:, 2] += zoff
    return pts.astype(np.float32)


def project_points(cam, Rwc, Pwc, pts):
    """Project world points into a camera (ideal pinhole). Returns uv (N,2), z (N,)."""
    Pc = (Rwc.T @ (pts - Pwc).T).T
    z = Pc[:, 2]
    z_safe = np.where(np.abs(z) < 1e-9, 1e-9, z)
    u = float(cam.fx) * Pc[:, 0] / z_safe + float(cam.cx)
    v = float(cam.fy) * Pc[:, 1] / z_safe + float(cam.cy)
    return np.stack([u, v], 1), z


def visible_mask(cam, uv, z, margin=0.0):
    return (z > 0.3) & (uv[:, 0] >= -margin) & (uv[:, 0] < cam.width + margin) \
        & (uv[:, 1] >= -margin) & (uv[:, 1] < cam.height + margin)
