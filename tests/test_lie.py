"""Unit tests for the Lie-group kernel (SURVEY.md section 7 step 1):
round-trips, group axioms, and finite-difference Jacobian identities."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_slam import lie


def random_rotvecs(rng, n=64, scale=2.5):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v = v * rng.uniform(0.0, scale, size=(n, 1)).astype(np.float32) / np.maximum(
        np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    # include tiny and zero angles
    v[0] = 0.0
    v[1] = 1e-8
    return jnp.asarray(v)


class TestSO3:
    def test_exp_log_roundtrip(self, rng):
        phi = random_rotvecs(rng)
        R = lie.so3_exp(phi)
        # orthonormality + det 1
        RtR = jnp.swapaxes(R, -1, -2) @ R
        np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-5)
        np.testing.assert_allclose(jnp.linalg.det(R), 1.0, atol=1e-5)
        phi2 = lie.so3_log(R)
        np.testing.assert_allclose(phi2, phi, atol=2e-5)

    def test_log_near_pi(self, rng):
        axis = rng.normal(size=(16, 3)).astype(np.float32)
        axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
        theta = np.float32(np.pi - 1e-3)
        phi = jnp.asarray(axis * theta)
        phi2 = lie.so3_log(lie.so3_exp(phi))
        np.testing.assert_allclose(phi2, phi, atol=1e-3)

    def test_hat_vee(self, rng):
        v = jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32))
        np.testing.assert_allclose(lie.vee(lie.hat(v)), v)

    def test_right_jacobian_fd(self, rng):
        """Exp(phi + J_r(phi) dphi) ~ Exp(phi) Exp(dphi) to first order — equivalently
        d/d eps Log(Exp(phi)^T Exp(phi + eps d)) = Jr^{-1}... Use the defining identity:
        Exp(phi + d) ~ Exp(phi) Exp(Jr(phi) d)."""
        phi = np.asarray(random_rotvecs(rng, 32))[2:]  # skip exact zero for fd stability
        d = rng.normal(size=phi.shape).astype(np.float32)
        eps = 1e-4
        lhs = lie.so3_exp(jnp.asarray(phi + eps * d))
        Jr = lie.so3_jr(jnp.asarray(phi))
        rhs = lie.so3_exp(jnp.asarray(phi)) @ lie.so3_exp(eps * jnp.einsum('nij,nj->ni', Jr, d))
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), atol=1e-6)

    def test_jr_inv(self, rng):
        phi = random_rotvecs(rng, 32)
        J = lie.so3_jr(phi) @ lie.so3_jr_inv(phi)
        np.testing.assert_allclose(J, np.broadcast_to(np.eye(3), J.shape), atol=1e-4)

    def test_jl_is_jr_neg(self, rng):
        phi = random_rotvecs(rng, 16)
        np.testing.assert_allclose(lie.so3_jl(phi), lie.so3_jr(-phi), atol=1e-6)

    def test_normalize(self, rng):
        R = lie.so3_exp(random_rotvecs(rng, 8))
        R_noisy = R + 1e-3 * jnp.asarray(rng.normal(size=R.shape).astype(np.float32))
        for Rn in (lie.so3_normalize(R_noisy), lie.so3_normalize_fast(R_noisy)):
            RtR = jnp.swapaxes(Rn, -1, -2) @ Rn
            np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-5)

    def test_grad_safe_at_zero(self):
        g = jax.grad(lambda p: jnp.sum(lie.so3_exp(p)))(jnp.zeros(3))
        assert np.all(np.isfinite(g))
        g2 = jax.grad(lambda p: jnp.sum(lie.so3_jr(p)))(jnp.zeros(3))
        assert np.all(np.isfinite(g2))


class TestSE3:
    def test_exp_log_roundtrip(self, rng):
        xi = jnp.asarray(rng.normal(size=(32, 6)).astype(np.float32))
        R, t = lie.se3_exp(xi)
        xi2 = lie.se3_log(R, t)
        np.testing.assert_allclose(xi2, xi, atol=1e-4)

    def test_inverse_compose(self, rng):
        xi = jnp.asarray(rng.normal(size=(8, 6)).astype(np.float32))
        R, t = lie.se3_exp(xi)
        Ri, ti = lie.se3_inv(R, t)
        Rc, tc = lie.se3_mul(R, t, Ri, ti)
        np.testing.assert_allclose(Rc, np.broadcast_to(np.eye(3), Rc.shape), atol=1e-5)
        np.testing.assert_allclose(tc, np.zeros_like(tc), atol=1e-5)


class TestSim3:
    def test_exp_log_roundtrip(self, rng):
        xi = jnp.asarray(rng.normal(size=(32, 7)).astype(np.float32) * 0.8)
        s, R, t = lie.sim3_exp(xi)
        xi2 = lie.sim3_log(s, R, t)
        np.testing.assert_allclose(xi2, xi, atol=1e-3)

    def test_identity(self):
        s, R, t = lie.sim3_exp(jnp.zeros(7))
        np.testing.assert_allclose(s, 1.0, atol=1e-6)
        np.testing.assert_allclose(R, np.eye(3), atol=1e-6)
        np.testing.assert_allclose(t, np.zeros(3), atol=1e-6)

    def test_sigma_only(self):
        xi = jnp.zeros(7).at[6].set(0.5).at[0].set(1.0)
        s, R, t = lie.sim3_exp(xi)
        np.testing.assert_allclose(s, np.exp(0.5), rtol=1e-6)
        # t = a * rho with a = (s-1)/sigma
        np.testing.assert_allclose(t[0], (np.exp(0.5) - 1) / 0.5, rtol=1e-5)

    def test_compose_inverse(self, rng):
        xi = jnp.asarray(rng.normal(size=(8, 7)).astype(np.float32) * 0.5)
        s, R, t = lie.sim3_exp(xi)
        si, Ri, ti = lie.sim3_inv(s, R, t)
        sc, Rc, tc = lie.sim3_mul(s, R, t, si, Ri, ti)
        np.testing.assert_allclose(sc, np.ones_like(sc), atol=1e-5)
        np.testing.assert_allclose(Rc, np.broadcast_to(np.eye(3), Rc.shape), atol=1e-5)
        np.testing.assert_allclose(tc, np.zeros_like(tc), atol=1e-4)
