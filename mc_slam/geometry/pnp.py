"""Batched RANSAC PnP for relocalization.

Replaces PnPsolver (src/PnPsolver.cpp, EPnP-in-RANSAC). Batched scheme:
all hypotheses at once — random 6-point minimal sets solved by the normalized
DLT (12-dim nullspace -> projection matrix -> polar-decomposed R, t), scored by
reprojection inliers over the full 2D-3D match set in one (B, N) pass; the best
hypothesis is refined by the caller with solver.ba.pose_only_visual (which
plays the role of the reference's internal EPnP Gauss-Newton refinement).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _dlt_pnp(Xw, xn, w=None):
    """P from >=6 points. Xw (B, M, 3), xn (B, M, 2) normalized coords,
    w optional (B, M) row weights (0 rows drop out of the LS problem).
    Returns (R (B,3,3) cam-from-world, t (B,3)) with unit-determinant R.

    Hartley-normalized: world points are centered and isotropically scaled
    per problem before building the design matrix (the classic conditioning
    fix — the raw DLT's algebraic error weights depth against image error
    badly and costs ~2 px of systematic reprojection at 0.5 px noise)."""
    B, M, _ = Xw.shape
    if w is None:
        wn = jnp.ones((B, M), Xw.dtype)
    else:
        wn = w
    wsum = jnp.maximum(jnp.sum(wn, -1, keepdims=True), 1e-9)
    mu3 = jnp.sum(Xw * wn[..., None], -2) / wsum             # (B, 3)
    d3 = jnp.linalg.norm(Xw - mu3[:, None, :], axis=-1)
    s3 = jnp.sqrt(3.0) / jnp.maximum(
        jnp.sum(d3 * wn, -1) / wsum[..., 0], 1e-9)           # (B,)
    Xn = (Xw - mu3[:, None, :]) * s3[:, None, None]

    o = jnp.zeros((B, M), Xw.dtype)
    l = jnp.ones((B, M), Xw.dtype)
    X, Y, Z = Xn[..., 0], Xn[..., 1], Xn[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    r1 = jnp.stack([X, Y, Z, l, o, o, o, o, -u * X, -u * Y, -u * Z, -u], axis=-1)
    r2 = jnp.stack([o, o, o, o, X, Y, Z, l, -v * X, -v * Y, -v * Z, -v], axis=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = jnp.concatenate([r1, r2], axis=-2)                   # (B, 2M, 12)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    Pn = Vt[..., 11, :].reshape(B, 3, 4)
    # denormalize: Pn maps X' = s3 (X - mu3), so P = [Pn[:, :3] * s3,
    # Pn[:, 3] - Pn[:, :3] @ (s3 mu3)] up to the common scale factor
    P = jnp.concatenate([
        Pn[..., :3] * s3[:, None, None],
        (Pn[..., 3] - jnp.einsum('bij,bj->bi', Pn[..., :3] * s3[:, None, None],
                                 mu3))[..., None]], axis=-1)
    # P is up to a signed scale; normalize so det(P[:, :3]) > 0 and ||rows|| ~ 1,
    # then polar-decompose onto SO(3)
    Rr = P[..., :3]
    sgn = jnp.sign(jnp.linalg.det(Rr))
    sgn = jnp.where(sgn == 0, jnp.ones_like(sgn), sgn)
    U, S, Vt2 = jnp.linalg.svd(Rr * sgn[..., None, None])
    scale = jnp.maximum(jnp.mean(S, axis=-1), 1e-12)
    R = U @ Vt2
    t = sgn[..., None] * P[..., 3] / scale[..., None]
    return R, t


class PnPResult(NamedTuple):
    ok: jnp.ndarray       # () bool
    R_cw: jnp.ndarray     # (3,3)
    t_cw: jnp.ndarray     # (3,)
    inliers: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray


@partial(jax.jit, static_argnames=("n_iters",))
def pnp_ransac(key, Xw, xn, w, focal, n_iters: int = 256, th_px: float = 5.991,
               min_inliers: int = 10):
    """Xw (N,3) world points, xn (N,2) normalized obs, w (N,) validity.

    th_px: squared-pixel inlier gate (chi2-style, scaled by focal internally).
    """
    N = Xw.shape[0]
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-12))[None, :].repeat(n_iters * 6, 0)
    ).reshape(n_iters, 6)
    R, t = _dlt_pnp(Xw[idx], xn[idx])                        # (B,3,3), (B,3)

    def score(R, t):
        Xc = jnp.einsum('bij,nj->bni', R, Xw) + t[:, None, :]
        z = Xc[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9 * jnp.ones_like(z), z)
        proj = Xc[..., :2] / z_safe[..., None]
        e = jnp.sum((proj - xn[None]) ** 2, axis=-1) * (focal * focal)
        inl = (e < th_px) & (z > 0) & (w[None] > 0)
        return inl, jnp.sum(inl, axis=-1)

    # score all hypotheses on all points
    inl, n_inl = score(R, t)
    b = jnp.argmax(n_inl)

    # local optimization (LO-RANSAC): iterate {Gauss-Newton on the current
    # inlier set's REPROJECTION error, rescore, expand the inlier set} and
    # keep the best state — the reference's EPnP-internal Gauss-Newton +
    # Refine loop (PnPsolver.cpp compute_pose). A weighted-DLT refit was
    # tried here and rejected: its algebraic error trades depth against
    # image error so badly that the refit scored FEWER inliers than the
    # minimal hypothesis it started from.
    def gn_step(R_c, t_c, w_in):
        Xc = Xw @ jnp.swapaxes(R_c, -1, -2) + t_c            # (N, 3)
        z = jnp.maximum(Xc[..., 2], 1e-6)
        proj = Xc[..., :2] / z[..., None]
        r = proj - xn                                        # (N, 2)
        iz = 1.0 / z
        # J wrt [dt, dphi] with R <- exp(phi^) R (left perturbation):
        # dXc = dt - hat(Xc) dphi
        Jp = jnp.stack([
            jnp.stack([iz, jnp.zeros_like(iz), -proj[..., 0] * iz], -1),
            jnp.stack([jnp.zeros_like(iz), iz, -proj[..., 1] * iz], -1)], -2)
        hatX = jnp.stack([
            jnp.stack([jnp.zeros_like(z), -Xc[..., 2], Xc[..., 1]], -1),
            jnp.stack([Xc[..., 2], jnp.zeros_like(z), -Xc[..., 0]], -1),
            jnp.stack([-Xc[..., 1], Xc[..., 0], jnp.zeros_like(z)], -1)], -2)
        J = jnp.concatenate([Jp, -jnp.einsum('nij,njk->nik', Jp, hatX)], -1)
        wj = (w_in * (Xc[..., 2] > 1e-6))[:, None, None] * J
        H = jnp.einsum('nri,nrj->ij', wj, J) + 1e-9 * jnp.eye(6, dtype=J.dtype)
        g = jnp.einsum('nri,nr->i', wj, r)
        dx = -jnp.linalg.solve(H, g)
        t_n = t_c + dx[:3]
        ph = dx[3:6]
        an = jnp.linalg.norm(ph) + 1e-12
        K = jnp.stack([jnp.stack([jnp.zeros(()), -ph[2], ph[1]]),
                       jnp.stack([ph[2], jnp.zeros(()), -ph[0]]),
                       jnp.stack([-ph[1], ph[0], jnp.zeros(())])])
        Rd = jnp.eye(3, dtype=R_c.dtype) + jnp.sin(an) / an * K \
            + (1 - jnp.cos(an)) / (an * an) * (K @ K)
        return Rd @ R_c, t_n

    R_best, t_best = R[b], t[b]
    inl_best, n_best = inl[b], n_inl[b]
    for _ in range(4):
        R2, t2 = gn_step(R_best, t_best, inl_best.astype(Xw.dtype))
        inl2, n_inl2 = score(R2[None], t2[None])
        # ties prefer the refined pose (it averages the sample noise down)
        better = n_inl2[0] >= n_best
        R_best = jnp.where(better, R2, R_best)
        t_best = jnp.where(better, t2, t_best)
        inl_best = jnp.where(better, inl2[0], inl_best)
        n_best = jnp.maximum(n_inl2[0], n_best)
    ok = n_best >= min_inliers
    return PnPResult(ok=ok, R_cw=R_best, t_cw=t_best, inliers=inl_best,
                     n_inliers=n_best)
