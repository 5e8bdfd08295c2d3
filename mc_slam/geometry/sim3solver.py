"""Horn closed-form Sim3 estimation + batched RANSAC.

Replaces Sim3Solver (src/Sim3Solver.cpp): Horn's quaternion absolute-orientation
method from 3-point sets inside RANSAC, scored by bidirectional reprojection,
with the bFixScale switch (SE3 for stereo/RGBD). All hypotheses are solved and
scored as one batch.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie


def horn_sim3(Pa, Pb, w=None, fix_scale=False):
    """Closed-form Sim3 aligning point sets: Pb ~ s R Pa + t.

    Pa, Pb: (..., M, 3); w optional (..., M) weights. Returns (s, R, t).
    Horn 1987 quaternion method with the symmetric scale of the reference
    (Sim3Solver::ComputeSim3).
    """
    if w is None:
        w = jnp.ones(Pa.shape[:-1], Pa.dtype)
    ws = jnp.maximum(jnp.sum(w, -1, keepdims=True), 1e-12)
    ca = jnp.sum(Pa * w[..., None], -2) / ws
    cb = jnp.sum(Pb * w[..., None], -2) / ws
    A = (Pa - ca[..., None, :]) * w[..., None]
    B = Pb - cb[..., None, :]
    # Horn's cross-covariance S = sum a b^T (rotation maps a -> b)
    M = jnp.einsum('...mi,...mj->...ij', A, B)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[..., :, -1]                       # max-eigenvalue quaternion (w,x,y,z)
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    R = _quat_to_rot(q)
    # symmetric scale: s = sqrt(sum||b'||^2 / sum||a'||^2) (Horn eq. 39-ish; the
    # reference uses D/Sa with rotated a — use the robust ratio form)
    Ar = jnp.einsum('...ij,...mj->...mi', R, Pa - ca[..., None, :])
    num = jnp.sum(jnp.sum(B * Ar, -1) * w, -1)
    den = jnp.sum(jnp.sum(Ar * Ar, -1) * w, -1)
    s = num / jnp.maximum(den, 1e-12)
    if fix_scale:
        s = jnp.ones_like(s)
    t = cb - s[..., None] * (R @ ca[..., None])[..., 0]
    return s, R, t


def _quat_to_rot(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


class Sim3Result(NamedTuple):
    ok: jnp.ndarray
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def sim3_ransac(key, Pa, Pb, w, focal, n_iters: int = 300, th_px2: float = 9.21,
                min_inliers: int = 20, fix_scale: bool = False):
    """RANSAC Horn Sim3 between matched 3D point sets (camera frames of KF1/KF2).

    Pa, Pb: (N,3) matched points; w validity; scored by bidirectional projection
    error in pixel units (th_px2 ~ chi2(2) 0.99 = 9.21, as the reference's
    mTh inlier gate)."""
    N = Pa.shape[0]
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-12))[None, :].repeat(n_iters * 3, 0)
    ).reshape(n_iters, 3)
    s, R, t = horn_sim3(Pa[idx], Pb[idx], fix_scale=fix_scale)   # (B,) (B,3,3) (B,3)

    # bidirectional projection scoring
    Pb_hat = s[:, None, None] * jnp.einsum('bij,nj->bni', R, Pa) + t[:, None, :]
    s_inv, R_inv, t_inv = lie.sim3_inv(s, R, t)
    Pa_hat = s_inv[:, None, None] * jnp.einsum('bij,nj->bni', R_inv, Pb) + t_inv[:, None, :]

    def perr(Xc, X):
        z1 = jnp.maximum(Xc[..., 2], 1e-9)
        z2 = jnp.maximum(X[..., 2], 1e-9)
        p1 = Xc[..., :2] / z1[..., None]
        p2 = X[None, ..., :2] / z2[None, ..., None]
        return jnp.sum((p1 - p2) ** 2, -1) * focal * focal

    e_b = perr(Pb_hat, Pb)
    e_a = perr(Pa_hat, Pa)
    inl = (e_b < th_px2) & (e_a < th_px2) & (w[None] > 0)
    n_inl = jnp.sum(inl, -1)
    b = jnp.argmax(n_inl)
    ok = n_inl[b] >= min_inliers
    # refine on the inlier set of the best hypothesis
    s2, R2, t2 = horn_sim3(Pa, Pb, w=inl[b].astype(Pa.dtype), fix_scale=fix_scale)
    return Sim3Result(ok=ok, s=s2, R=R2, t=t2, inliers=inl[b], n_inliers=n_inl[b])
