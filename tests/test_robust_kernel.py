"""Robust-kernel and LM-protocol invariants (solver/lm.py).

These lock in the fixes for two observed failure modes:
  * landmark teleports: with an UNBOUNDED Huber and a flat behind-camera
    penalty, Schur BA could strictly lower its cost by pushing contested
    landmarks out of the frustum (see lm.HUBER_TRUNC);
  * convergence-basin loss: a tight truncation zeroes the gradient of a
    merely-perturbed initialization.
"""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam.solver import lm


def test_behind_camera_never_cheaper_than_in_view():
    """For EVERY chi2, the in-view truncated cost <= the behind-camera
    plateau — the exact invariant that blocks the frustum-escape exploit."""
    d2 = 5.991
    chi2 = jnp.asarray(np.geomspace(1e-6, 1e12, 200), jnp.float32)
    rho = lm.trunc_huber_cost(chi2, d2)
    plateau = float(lm.trunc_plateau(d2))
    assert float(jnp.max(rho)) <= plateau + 1e-4
    # and the kernel is continuous at the truncation point
    t = lm.HUBER_TRUNC * d2
    lo = float(lm.trunc_huber_cost(jnp.asarray(t * 0.999), d2))
    hi = float(lm.trunc_huber_cost(jnp.asarray(t * 1.001), d2))
    assert abs(lo - hi) < 0.01 * plateau


def test_trunc_weight_keeps_moderate_outlier_gradient():
    """A ~10 px residual (chi2 ~ 100) must keep the full Huber pull; a
    certain association error (beyond the truncation) must have none."""
    d2 = 5.991
    w_mod = float(lm.trunc_huber_weight(jnp.asarray(100.0), d2))
    w_hub = float(lm.huber_weight(jnp.asarray(100.0), d2))
    assert abs(w_mod - w_hub) < 1e-6
    w_out = float(lm.trunc_huber_weight(jnp.asarray(lm.HUBER_TRUNC * d2 * 2), d2))
    assert w_out == 0.0


def test_trunc_weight_continuous_in_chi2():
    d2 = 5.991
    T = lm.HUBER_TRUNC * d2
    xs = jnp.asarray(np.linspace(0.5 * T, 1.1 * T, 500), jnp.float32)
    w = np.asarray(lm.trunc_huber_weight(xs, d2))
    assert np.all(np.abs(np.diff(w)) < 5e-4), "weight must ramp, not step"


def test_damp_point_blocks_bounds_nullspace_step():
    """A rank-deficient landmark block (zero curvature along one axis) must
    still produce a bounded solve: the scale-aware absolute floor keeps the
    inverse finite relative to the problem's information scale."""
    Hpp = np.zeros((4, 3, 3), np.float32)
    # three well-conditioned points at information ~1e4
    for i in range(3):
        Hpp[i] = np.diag([1e4, 1e4, 1e4])
    # one point with a zero-curvature z axis (low-parallax depth direction)
    Hpp[3] = np.diag([1e4, 1e4, 0.0])
    lam = jnp.asarray(1e-4, jnp.float32)
    Hd = np.asarray(lm.damp_point_blocks(jnp.asarray(Hpp), lam))
    inv = np.linalg.inv(Hd[3])
    # step along the nullspace axis for unit gradient must be <= ~1/(1e-3*diag*lam)
    assert inv[2, 2] < 1.0 / (1e-3 * 1e4 * 1e-4) * 1.01
    # well-conditioned axes are barely affected
    assert abs(inv[0, 0] - 1e-4) < 2e-6


def test_two_phase_reclassifies_outliers():
    """1-D line fit with a planted outlier: phase 1 (robust) pulls near the
    consensus, phase 2 removes the outlier and lands exactly on it."""
    xs = np.linspace(0, 1, 20).astype(np.float32)
    ys = (2.0 * xs).astype(np.float32)
    ys[7] += 30.0      # gross outlier
    xs_j, ys_j = jnp.asarray(xs), jnp.asarray(ys)
    d2 = 1.0

    def make_fns(valid):
        def cost_fn(a):
            r2 = (a * xs_j - ys_j) ** 2
            return jnp.sum(valid * lm.trunc_huber_cost(r2, d2))

        def linearize_solve(a, lam):
            r = a * xs_j - ys_j
            w = valid * lm.trunc_huber_weight(r ** 2, d2)
            H = jnp.sum(w * xs_j * xs_j) * (1 + lam) + 1e-9
            g = jnp.sum(w * xs_j * r)
            return -g / H

        def retract(a, da):
            return a + da

        return linearize_solve, retract, cost_fn

    def classify(a, valid0):
        r2 = (a * xs_j - ys_j) ** 2
        return valid0 * (r2 <= d2).astype(valid0.dtype)

    valid0 = jnp.ones_like(xs_j)
    a2, cost, _ = lm.lm_two_phase(jnp.asarray(0.0), make_fns, valid0, classify,
                                  iters=12)
    assert abs(float(a2) - 2.0) < 1e-3
    # abortable mode (rtol > 0) runs a single phase — still converges here,
    # because the truncated kernel zeroes the planted outlier anyway
    a1, _, _ = lm.lm_two_phase(jnp.asarray(0.0), make_fns, valid0, classify,
                               iters=12, rtol=1e-6)
    assert abs(float(a1) - 2.0) < 0.05


def test_pnp_lo_ransac_refit_beats_minimal():
    """The weighted-DLT local optimization must not degrade the minimal-set
    solution and typically lifts near-threshold inlier counts."""
    from mc_slam.geometry import pnp
    rng = np.random.default_rng(3)
    N = 80
    Xw = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    Xw[:, 2] += 5.0
    R = np.eye(3, dtype=np.float32)
    t = np.asarray([0.1, -0.2, 0.3], np.float32)
    Xc = Xw @ R.T + t
    xn = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    xn += rng.normal(0, 0.5 / 300.0, xn.shape).astype(np.float32)  # 0.5 px
    # 30% outliers
    out = rng.random(N) < 0.3
    xn[out] += rng.uniform(0.05, 0.3, (out.sum(), 2)).astype(np.float32)
    res = pnp.pnp_ransac(jax.random.PRNGKey(0), jnp.asarray(Xw),
                         jnp.asarray(xn), jnp.ones(N), 300.0,
                         min_inliers=12)
    assert bool(res.ok)
    # the contract is "accurate enough for the downstream pose-only LM
    # refine" (reloc always refines, system.py _relocalize): a healthy
    # inlier count and sub-degree/centimeter pose from noisy 30%-outlier
    # data. (The DLT is unnormalized, so with 0.5 px noise the raw count
    # undershoots the true inlier set — the refine recovers those.)
    assert int(res.n_inliers) >= 0.5 * (N - out.sum())
    dR = np.asarray(res.R_cw) @ R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.0, ang
    # the operative accuracy measure is reprojection (z-translation trades
    # against depth in a DLT and the refine absorbs that): median error of
    # the TRUE inlier set under the estimated pose must be ~the noise floor
    Xc_est = Xw @ np.asarray(res.R_cw).T + np.asarray(res.t_cw)
    proj = Xc_est[:, :2] / Xc_est[:, 2:3]
    err_px = np.linalg.norm(proj - xn, axis=1)[~out] * 300.0
    assert np.median(err_px) < 2.0, np.median(err_px)
