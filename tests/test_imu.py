"""IMU preintegration tests (SURVEY.md section 7 step 2): recursion vs direct
integration, bias-Jacobian finite differences, covariance PSD, padding no-op,
and NavState prediction consistency on an analytic trajectory."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.imu.navstate import NavState, navstate_identity, inc_small
from mc_slam.imu.preintegration import (
    euroc_noise, preint_identity, preintegrate, predict_navstate,
)


def make_samples(rng, T=100, dt=0.005):
    omega = rng.normal(size=(T, 3)).astype(np.float32) * 0.3
    acc = (rng.normal(size=(T, 3)) * 0.5 + np.array([0, 0, 9.81])).astype(np.float32)
    dts = np.full((T, 1), dt, np.float32)
    return jnp.asarray(np.concatenate([omega, acc, dts], axis=1))


def test_zero_dt_padding_is_noop(rng):
    s = make_samples(rng, 50)
    padded = jnp.concatenate([s, jnp.zeros((30, 7), s.dtype)], axis=0)
    bg = jnp.zeros(3)
    ba = jnp.zeros(3)
    n = euroc_noise()
    a = preintegrate(s, bg, ba, n)
    b = preintegrate(padded, bg, ba, n)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-7)


def test_delta_R_matches_sequential_rotation(rng):
    s = make_samples(rng, 200)
    n = euroc_noise()
    out = preintegrate(s, jnp.zeros(3), jnp.zeros(3), n)
    # direct product of incremental rotations
    R = np.eye(3, dtype=np.float64)
    for row in np.asarray(s, np.float64):
        R = R @ np.asarray(lie.so3_exp(jnp.asarray(row[:3] * row[6], jnp.float64)))
    np.testing.assert_allclose(np.asarray(out.dR), R, atol=1e-4)
    np.testing.assert_allclose(out.dT, 1.0, atol=1e-6)


def test_constant_accel_closed_form():
    """Pure constant accel, zero gyro: dP = 0.5 a T^2, dV = a T."""
    T, dt = 200, 0.005
    a = np.array([1.0, -2.0, 0.5], np.float32)
    s = np.zeros((T, 7), np.float32)
    s[:, 3:6] = a
    s[:, 6] = dt
    out = preintegrate(jnp.asarray(s), jnp.zeros(3), jnp.zeros(3), euroc_noise())
    Ttot = T * dt
    np.testing.assert_allclose(out.dV, a * Ttot, rtol=1e-5)
    np.testing.assert_allclose(out.dP, 0.5 * a * Ttot**2, rtol=1e-3)


def test_bias_jacobians_fd(rng):
    """First-order bias correction via stored Jacobians must match re-integration
    with perturbed bias (Forster eq. 44 linearization)."""
    s = make_samples(rng, 100)
    n = euroc_noise()
    bg0 = jnp.asarray([0.01, -0.02, 0.005])
    ba0 = jnp.asarray([0.05, 0.1, -0.03])
    base = preintegrate(s, bg0, ba0, n)
    db = 1e-4
    for k in range(3):
        dbg = jnp.zeros(3).at[k].set(db)
        pert = preintegrate(s, bg0 + dbg, ba0, n)
        np.testing.assert_allclose(
            np.asarray(pert.dP), np.asarray(base.dP + base.J_P_bg @ dbg), atol=5e-6)
        np.testing.assert_allclose(
            np.asarray(pert.dV), np.asarray(base.dV + base.J_V_bg @ dbg), atol=5e-6)
        # rotation: dR(b+db) ~ dR(b) @ Exp(J_R_bg db)
        pred = base.dR @ lie.so3_exp(base.J_R_bg @ dbg)
        np.testing.assert_allclose(np.asarray(pert.dR), np.asarray(pred), atol=5e-6)
        dba = jnp.zeros(3).at[k].set(db)
        pert_a = preintegrate(s, bg0, ba0 + dba, n)
        np.testing.assert_allclose(
            np.asarray(pert_a.dP), np.asarray(base.dP + base.J_P_ba @ dba), atol=5e-6)
        np.testing.assert_allclose(
            np.asarray(pert_a.dV), np.asarray(base.dV + base.J_V_ba @ dba), atol=5e-6)


def test_covariance_psd_and_growth(rng):
    s = make_samples(rng, 200)
    out = preintegrate(s, jnp.zeros(3), jnp.zeros(3), euroc_noise())
    cov = np.asarray(out.cov, np.float64)
    np.testing.assert_allclose(cov, cov.T, atol=1e-12)
    w = np.linalg.eigvalsh(cov)
    assert w.min() >= -1e-12
    assert w.max() > 0


def test_predict_navstate_gravity_only():
    """Free fall with zero IMU readings: body accelerates at g."""
    T, dt = 100, 0.01
    s = np.zeros((T, 7), np.float32)
    s[:, 6] = dt
    pre = preintegrate(jnp.asarray(s), jnp.zeros(3), jnp.zeros(3), euroc_noise())
    ns0 = navstate_identity()
    gw = jnp.asarray([0.0, 0.0, -9.81])
    ns1 = predict_navstate(ns0, pre, gw)
    Ttot = T * dt
    np.testing.assert_allclose(ns1.V, np.array([0, 0, -9.81 * Ttot]), rtol=1e-5)
    np.testing.assert_allclose(ns1.P, np.array([0, 0, -0.5 * 9.81 * Ttot**2]), rtol=1e-4)
    np.testing.assert_allclose(ns1.R, np.eye(3), atol=1e-6)


def test_predict_navstate_stationary():
    """Stationary IMU measuring exactly -g in body frame: state must not move."""
    T, dt = 100, 0.01
    s = np.zeros((T, 7), np.float32)
    s[:, 5] = 9.81  # accel measures specific force +g z
    s[:, 6] = dt
    pre = preintegrate(jnp.asarray(s), jnp.zeros(3), jnp.zeros(3), euroc_noise())
    ns1 = predict_navstate(navstate_identity(), pre, jnp.asarray([0.0, 0.0, -9.81]))
    np.testing.assert_allclose(ns1.P, np.zeros(3), atol=1e-4)
    np.testing.assert_allclose(ns1.V, np.zeros(3), atol=1e-4)


def test_batched_vmap(rng):
    sb = jnp.stack([make_samples(rng, 64), make_samples(rng, 64)])
    n = euroc_noise()
    out = jax.vmap(lambda s: preintegrate(s, jnp.zeros(3), jnp.zeros(3), n))(sb)
    assert out.dP.shape == (2, 3)
    single = preintegrate(sb[0], jnp.zeros(3), jnp.zeros(3), n)
    np.testing.assert_allclose(out.dP[0], single.dP, atol=1e-7)


def test_navstate_retraction():
    ns = navstate_identity()
    upd = jnp.arange(15, dtype=jnp.float32) * 0.01
    ns2 = inc_small(ns, upd)
    np.testing.assert_allclose(ns2.P, [0.0, 0.01, 0.02])
    np.testing.assert_allclose(ns2.V, [0.03, 0.04, 0.05])
    np.testing.assert_allclose(ns2.R, np.asarray(lie.so3_exp(upd[6:9])), atol=1e-7)
    np.testing.assert_allclose(ns2.dbg, [0.09, 0.10, 0.11], atol=1e-7)
