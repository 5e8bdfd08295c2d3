"""Batched Lie-group math on SO(3) / SE(3) / Sim(3).

Batched replacement for the reference's vendored Sophus SO3
(/root/reference/src/IMU/so3.{h,cpp}) and g2o's se3quat.h / sim3.h.

Design notes
------------
* Canonical rotation representation is the 3x3 matrix ``(..., 3, 3)`` — matmul-friendly
  and free of quaternion sign ambiguity inside optimization loops.
* All functions broadcast over leading batch dims and are jit/vmap/grad-safe: the
  small-angle branches are implemented with ``jnp.where`` on *safe* inputs so gradients
  never see NaN (the classic where-grad trap).
* dtype follows the input. SLAM solvers default to float32 on the device; tests may run float64
  on CPU (``jax_enable_x64``) to validate against finite differences.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-6  # small-angle switch (rad). f32-safe: theta^2 ~ 1e-12 still representable.


def hat(v):
    """so(3) hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-1),
            jnp.stack([z, o, -x], axis=-1),
            jnp.stack([-y, x, o], axis=-1),
        ],
        axis=-2,
    )


def vee(W):
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _theta_sq(phi):
    return jnp.sum(phi * phi, axis=-1)


def _taylor_coeffs(theta_sq):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) with Taylor fallbacks.

    Gradient-safe: evaluates the trig branch at a clamped-away-from-zero theta.
    """
    small = theta_sq < _EPS**2
    # safe theta(_sq), never 0, so the trig branch has finite values AND grads
    # everywhere (the untaken branch of jnp.where still propagates cotangents).
    ts_safe = jnp.where(small, jnp.ones_like(theta_sq), theta_sq)
    theta = jnp.sqrt(ts_safe)
    st, ct = jnp.sin(theta), jnp.cos(theta)
    A = jnp.where(small, 1.0 - theta_sq / 6.0 + theta_sq**2 / 120.0, st / theta)
    B = jnp.where(small, 0.5 - theta_sq / 24.0 + theta_sq**2 / 720.0, (1.0 - ct) / ts_safe)
    C = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0 + theta_sq**2 / 5040.0, (theta - st) / (ts_safe * theta))
    return A, B, C


def so3_exp(phi):
    """Exponential map so(3) -> SO(3): (...,3) -> (...,3,3). Rodrigues formula."""
    ts = _theta_sq(phi)
    A, B, _ = _taylor_coeffs(ts)
    W = hat(phi)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * W2


def so3_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0.

    Branchless Shepperd's method: computes all four candidate extractions and
    selects the numerically best (largest pivot) per batch element. Accurate over
    the whole group including theta ~ pi, unlike the trace formula.
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + r00 + r11 + r22
    t1 = 1.0 + r00 - r11 - r22
    t2 = 1.0 - r00 + r11 - r22
    t3 = 1.0 - r00 - r11 + r22
    # candidate quats (unnormalized); candidate i has component i equal to t_i
    q0 = jnp.stack([t0, r21 - r12, r02 - r20, r10 - r01], axis=-1)
    q1 = jnp.stack([r21 - r12, t1, r01 + r10, r02 + r20], axis=-1)
    q2 = jnp.stack([r02 - r20, r01 + r10, t2, r12 + r21], axis=-1)
    q3 = jnp.stack([r10 - r01, r02 + r20, r12 + r21, t3], axis=-1)
    ts = jnp.stack([t0, t1, t2, t3], axis=-1)
    idx = jnp.argmax(ts, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(qs, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-20)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def so3_log(R):
    """Logarithm map SO(3) -> so(3): (...,3,3) -> (...,3), via quaternion."""
    q = so3_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    vn = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn < _EPS
    vn_safe = jnp.where(small, jnp.ones_like(vn), vn)
    # phi = theta * v / |v|; small angle: theta ~ 2 vn / w  =>  phi ~ 2 v / w
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 0.5), theta / vn_safe)
    return scale[..., None] * v


def so3_jr(phi):
    """Right Jacobian of SO(3): Jr(phi) = I - B*hat + C*hat^2 (Forster eq. 8)."""
    ts = _theta_sq(phi)
    _, B, C = _taylor_coeffs(ts)
    W = hat(phi)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I - B[..., None, None] * W + C[..., None, None] * W2


def so3_jl(phi):
    """Left Jacobian: Jl(phi) = Jr(-phi) = I + B*hat + C*hat^2."""
    ts = _theta_sq(phi)
    _, B, C = _taylor_coeffs(ts)
    W = hat(phi)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I + B[..., None, None] * W + C[..., None, None] * W2


def _jr_inv_coeff(ts):
    """k(t) = 1/t^2 - (1+cos t)/(2 t sin t), Taylor 1/12 + t^2/720 + t^4/30240 near 0."""
    small = ts < _EPS**2
    ts_safe = jnp.where(small, jnp.ones_like(ts), ts)
    t = jnp.sqrt(ts_safe)
    st, ct = jnp.sin(t), jnp.cos(t)
    k_big = 1.0 / ts_safe - (1.0 + ct) / (2.0 * t * st)
    k_small = 1.0 / 12.0 + ts / 720.0 + ts * ts / 30240.0
    return jnp.where(small, k_small, k_big)


def so3_jr_inv(phi):
    """Inverse right Jacobian: Jr^{-1}(phi) = I + hat/2 + k*hat^2."""
    ts = _theta_sq(phi)
    k = _jr_inv_coeff(ts)
    W = hat(phi)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I + 0.5 * W + k[..., None, None] * W2


def so3_jl_inv(phi):
    """Inverse left Jacobian: Jl^{-1}(phi) = I - hat/2 + k*hat^2."""
    ts = _theta_sq(phi)
    k = _jr_inv_coeff(ts)
    W = hat(phi)
    W2 = W @ W
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I - 0.5 * W + k[..., None, None] * W2


def so3_normalize(R):
    """Project a near-rotation matrix back onto SO(3) via SVD (polar decomposition).

    Replacement for the reference's quaternion renormalization
    (src/IMU/IMUPreintegrator.h:156-174).
    """
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    # flip last column of U where det == -1 to stay in SO(3)
    U = U.at[..., :, -1].multiply(jnp.sign(det)[..., None])
    return U @ Vt


def so3_normalize_fast(R):
    """Cheap Gram-Schmidt re-orthonormalization (no SVD) for hot loops."""
    r0 = R[..., 0, :]
    r0 = r0 / jnp.maximum(jnp.linalg.norm(r0, axis=-1, keepdims=True), 1e-12)
    r1 = R[..., 1, :]
    r1 = r1 - jnp.sum(r0 * r1, axis=-1, keepdims=True) * r0
    r1 = r1 / jnp.maximum(jnp.linalg.norm(r1, axis=-1, keepdims=True), 1e-12)
    r2 = jnp.cross(r0, r1)
    return jnp.stack([r0, r1, r2], axis=-2)


# ---------------------------------------------------------------------------
# SE(3): represented as (R: (...,3,3), t: (...,3)). x_out = R @ x + t.
# ---------------------------------------------------------------------------

def se3_exp(xi):
    """Exp of twist xi = [rho, phi] (translation first, matching g2o se3quat order
    used by the reference's vertices): (...,6) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_jl(phi)
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """Log map SE(3) -> twist [rho, phi]."""
    phi = so3_log(R)
    Vinv = so3_jl_inv(phi)
    rho = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inv(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_mul(Ra, ta, Rb, tb):
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, x):
    return (R @ x[..., None])[..., 0] + t


# ---------------------------------------------------------------------------
# Sim(3): (s: (...,), R: (...,3,3), t: (...,3)). x_out = s * R @ x + t.
# Matches g2o sim3.h semantics used for loop closure.
# ---------------------------------------------------------------------------

def sim3_exp(xi):
    """Exp of sim(3) element xi = [rho(3), phi(3), sigma(1)]: (...,7) -> (s, R, t).

    t = W @ rho with W = a*I + b*hat(phi) + c*hat(phi)^2, the closed-form Sim(3)
    "V" matrix (Strasdat's thesis / g2o sim3.h):
        a = (s - 1) / sigma
        b = (s*(sigma*sin t - t*cos t) + t) / (t*(sigma^2 + t^2))
        c = (a - (s*(sigma*cos t + t*sin t) - sigma)/(sigma^2 + t^2)) / t^2
    with Taylor fallbacks for sigma -> 0 and/or t -> 0.
    """
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    ts = _theta_sq(phi)
    small_t = ts < _EPS**2
    theta = jnp.sqrt(jnp.where(small_t, jnp.ones_like(ts), ts))
    small_s = jnp.abs(sigma) < _EPS
    sig = jnp.where(small_s, jnp.ones_like(sigma), sigma)

    st, ct = jnp.sin(theta), jnp.cos(theta)
    a = jnp.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig)

    den = jnp.where(small_t & small_s, jnp.ones_like(ts), sig * sig + ts)
    b_full = (s * (sig * st - theta * ct) + theta) / (theta * den)
    c_full = (a - (s * (sig * ct + theta * st) - sig) / den) / jnp.where(
        small_t, jnp.ones_like(ts), ts
    )

    # sigma -> 0 (theta general): reduces to the SE(3) left-Jacobian coefficients.
    _, B0, C0 = _taylor_coeffs(ts)
    # theta -> 0 (sigma general):
    b_t0 = jnp.where(
        small_s,
        0.5 + sigma / 6.0,
        (s * (sig - 1.0) + 1.0) / (sig * sig),
    )
    c_t0 = jnp.where(
        small_s,
        1.0 / 6.0 + sigma / 24.0,
        (s * (0.5 * sig * sig - sig + 1.0) - 1.0) / (sig ** 3),
    )

    b = jnp.where(small_t, b_t0, jnp.where(small_s, B0, b_full))
    c = jnp.where(small_t, c_t0, jnp.where(small_s, C0, c_full))

    W_ = hat(phi)
    W2 = W_ @ W_
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W_.shape)
    Wm = a[..., None, None] * I + b[..., None, None] * W_ + c[..., None, None] * W2
    t_out = (Wm @ rho[..., None])[..., 0]
    return s, R, t_out


def sim3_inv(s, R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def sim3_mul(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def sim3_apply(s, R, t, x):
    return s[..., None] * (R @ x[..., None])[..., 0] + t


def sim3_adjoint(s, R, t):
    """Adjoint of Sim(3) in [rho, phi, sigma] coordinates:
    Ad = [[s R, hat(t) R, -t], [0, R, 0], [0, 0, 1]] — maps a left-multiplicative
    tangent on the identity side through conjugation by (s, R, t)."""
    sh = s.shape
    A = jnp.zeros(sh + (7, 7), R.dtype)
    A = A.at[..., :3, :3].set(s[..., None, None] * R)
    A = A.at[..., :3, 3:6].set(hat(t) @ R)
    A = A.at[..., :3, 6].set(-t)
    A = A.at[..., 3:6, 3:6].set(R)
    A = A.at[..., 6, 6].set(1.0)
    return A


def sim3_log(s, R, t):
    """Log map Sim(3) -> (...,7) [rho, phi, sigma]. Inverse of sim3_exp (via solve)."""
    sigma = jnp.log(s)
    phi = so3_log(R)
    # Recompute W from (sigma, phi) and solve W rho = t.
    xi_sr = jnp.concatenate([jnp.zeros_like(phi), phi, sigma[..., None]], axis=-1)
    _, _, w_e1 = sim3_exp(jnp.concatenate([jnp.stack([jnp.ones_like(sigma), jnp.zeros_like(sigma), jnp.zeros_like(sigma)], -1), phi, sigma[..., None]], axis=-1))
    _, _, w_e2 = sim3_exp(jnp.concatenate([jnp.stack([jnp.zeros_like(sigma), jnp.ones_like(sigma), jnp.zeros_like(sigma)], -1), phi, sigma[..., None]], axis=-1))
    _, _, w_e3 = sim3_exp(jnp.concatenate([jnp.stack([jnp.zeros_like(sigma), jnp.zeros_like(sigma), jnp.ones_like(sigma)], -1), phi, sigma[..., None]], axis=-1))
    Wm = jnp.stack([w_e1, w_e2, w_e3], axis=-1)  # columns are W @ e_i
    rho = jnp.linalg.solve(Wm, t[..., None])[..., 0]
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)
