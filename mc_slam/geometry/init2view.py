"""Monocular two-view bootstrap: parallel H/F RANSAC, model selection,
reconstruction with cheirality + parallax checks.

Replaces Initializer (src/Initializer.cpp): FindHomography/FindFundamental
(200 iterations of 8-point sets, symmetric transfer scoring with chi2 gates
5.991/3.841), ReconstructH (plane-induced decomposition) / ReconstructF
(E = K^T F K -> 4 motion hypotheses), CheckRT triangulation audit, and the
RH = SH/(SH+SF) > 0.40 selection rule.

Batched shape: ALL RANSAC hypotheses are solved and scored as one batch —
200 SVDs of 9x9/18x9 systems and a (200, N) scoring matrix instead of a serial
loop. Everything is fixed-shape; match validity is a weight column.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.geometry.triangulation import parallax_cos, triangulate_two_view

SIGMA = 1.0              # reference Initializer sigma
TH_H = 5.991             # chi2(2) gate for homography transfer error
TH_F = 3.841             # chi2(1) gate for epipolar distance
SCORE_GAMMA_H = 5.991    # score offset (reference uses th for H
SCORE_GAMMA_F = 5.991    #               and thScore=5.991 for F)


def _normalize_points(xn, w):
    """Hartley normalization with validity weights. Returns (xh, T) with
    T a 3x3 similarity mapping raw -> normalized homogeneous coords."""
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(xn * w[:, None], axis=0) / wsum
    d = jnp.abs(xn - mean)
    md = jnp.sum(d * w[:, None], axis=0) / wsum
    s = 1.0 / jnp.maximum(md, 1e-9)
    xh = (xn - mean) * s
    T = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], xn.dtype)
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return xh, T


def _dlt_homography(x0, x1):
    """H from >=4 correspondences (B, M, 2) each -> (B, 3, 3), x1 ~ H x0."""
    B, M, _ = x0.shape
    o = jnp.zeros((B, M), x0.dtype)
    l = jnp.ones((B, M), x0.dtype)
    u, v = x0[..., 0], x0[..., 1]
    up, vp = x1[..., 0], x1[..., 1]
    r1 = jnp.stack([o, o, o, -u, -v, -l, vp * u, vp * v, vp], axis=-1)
    r2 = jnp.stack([u, v, l, o, o, o, -up * u, -up * v, -up], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)                     # (B, 2M, 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    return Vt[..., 8, :].reshape(B, 3, 3)


def _eight_point_f(x0, x1):
    """F from >=8 correspondences (B, M, 2) -> (B, 3, 3) rank-2 enforced."""
    B, M, _ = x0.shape
    u, v = x0[..., 0], x0[..., 1]
    up, vp = x1[..., 0], x1[..., 1]
    l = jnp.ones((B, M), x0.dtype)
    A = jnp.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, l], axis=-1)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    F = Vt[..., 8, :].reshape(B, 3, 3)
    U, S, Vt2 = jnp.linalg.svd(F)
    S = S.at[..., 2].set(0.0)
    return U @ (S[..., None] * Vt2)


def _apply_h(H, x):
    xh = jnp.concatenate([x, jnp.ones(x.shape[:-1] + (1,), x.dtype)], axis=-1)
    y = jnp.einsum('...ij,...nj->...ni', H, xh)
    w = y[..., 2]
    w_safe = jnp.where(jnp.abs(w) < 1e-12, 1e-12 * jnp.ones_like(w), w)
    return y[..., :2] / w_safe[..., None]


def score_homography(H, Hinv, uv0, uv1, w, sigma=SIGMA):
    """Symmetric transfer score (Initializer::CheckHomography)."""
    inv_s2 = 1.0 / (sigma * sigma)
    e01 = jnp.sum((uv1 - _apply_h(H, uv0)) ** 2, axis=-1) * inv_s2
    e10 = jnp.sum((uv0 - _apply_h(Hinv, uv1)) ** 2, axis=-1) * inv_s2
    in01 = e01 < TH_H
    in10 = e10 < TH_H
    sc = jnp.where(in01, SCORE_GAMMA_H - e01, 0.0) + jnp.where(in10, SCORE_GAMMA_H - e10, 0.0)
    inlier = in01 & in10
    return jnp.sum(sc * w, axis=-1), inlier & (w > 0)


def score_fundamental(F, uv0, uv1, w, sigma=SIGMA):
    """Symmetric epipolar-distance score (Initializer::CheckFundamental)."""
    inv_s2 = 1.0 / (sigma * sigma)
    x0 = jnp.concatenate([uv0, jnp.ones(uv0.shape[:-1] + (1,), uv0.dtype)], -1)
    x1 = jnp.concatenate([uv1, jnp.ones(uv1.shape[:-1] + (1,), uv1.dtype)], -1)
    l1 = jnp.einsum('...ij,...nj->...ni', F, x0)               # line in image 1
    l0 = jnp.einsum('...ji,...nj->...ni', F, x1)               # line in image 0
    d1 = jnp.sum(l1 * x1, axis=-1) ** 2 / jnp.maximum(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12) * inv_s2
    d0 = jnp.sum(l0 * x0, axis=-1) ** 2 / jnp.maximum(
        l0[..., 0] ** 2 + l0[..., 1] ** 2, 1e-12) * inv_s2
    in1 = d1 < TH_F
    in0 = d0 < TH_F
    sc = jnp.where(in1, SCORE_GAMMA_F - d1, 0.0) + jnp.where(in0, SCORE_GAMMA_F - d0, 0.0)
    return jnp.sum(sc * w, axis=-1), in0 & in1 & (w > 0)


class TwoViewResult(NamedTuple):
    ok: jnp.ndarray        # () bool
    used_h: jnp.ndarray    # () bool — which model was selected
    R: jnp.ndarray         # (3,3) world(cam0)-from-cam1 rotation (cam0 = identity)
    t: jnp.ndarray         # (3,) cam1 center in cam0 frame (unit-ish scale)
    Xw: jnp.ndarray        # (N,3) triangulated points in cam0 frame
    good: jnp.ndarray      # (N,) bool triangulation accepted
    n_good: jnp.ndarray    # () int32
    score_h: jnp.ndarray
    score_f: jnp.ndarray


def _check_rt(R, t, xn0, xn1, w, th_reproj=4.0, min_par_cos=0.99998):
    """Triangulate under (R, t) and audit: positive depths, parallax, reprojection
    (Initializer::CheckRT). xn are normalized coords; th in normalized units is
    scaled by a nominal focal for parity with the 4px^2 pixel gate (caller scales)."""
    I = jnp.eye(3, dtype=R.dtype)
    z = jnp.zeros(3, R.dtype)
    Xw, d0, d1 = triangulate_two_view(I, z, R, t, xn0, xn1)
    cosp = parallax_cos(z, t, Xw)
    finite = jnp.all(jnp.isfinite(Xw), axis=-1)
    pos = (d0 > 0) & (d1 > 0)
    # reprojection in normalized coords
    e0 = jnp.sum((Xw[..., :2] / jnp.maximum(Xw[..., 2:3], 1e-9) - xn0) ** 2, -1)
    Xc1 = (jnp.swapaxes(R, -1, -2) @ (Xw - t)[..., None])[..., 0]
    e1 = jnp.sum((Xc1[..., :2] / jnp.maximum(Xc1[..., 2:3], 1e-9) - xn1) ** 2, -1)
    ok_rep = (e0 < th_reproj) & (e1 < th_reproj)
    good = finite & pos & (cosp < min_par_cos) & ok_rep & (w > 0)
    return Xw, good, jnp.sum(good), cosp


def _decompose_e(E):
    """E -> 4 (R, t) hypotheses (Initializer::DecomposeE)."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    d = jnp.linalg.det(U @ Vt)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    t = U[..., :, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    # NOTE: these are cam1-from-cam0 (Rcw, tcw) style; convert to world-from-cam1:
    # x1 = R x0 + t  =>  cam1 pose in cam0 frame: Rwc1 = R^T, C1 = -R^T t
    def to_pose(Rr, tt):
        Rwc = jnp.swapaxes(Rr, -1, -2)
        C = -(Rwc @ tt[..., None])[..., 0]
        return Rwc, C
    return [to_pose(R1, t), to_pose(R1, -t), to_pose(R2, t), to_pose(R2, -t)]


def _decompose_h_normalized(H):
    """Plane-induced homography decomposition (x1 = H x0 in normalized coords)
    via the SVD method; returns 8 (R, t) world-from-cam1 hypotheses
    (Initializer::ReconstructH, Faugeras-style)."""
    U, S, Vt = jnp.linalg.svd(H)
    s = jnp.linalg.det(U) * jnp.linalg.det(jnp.swapaxes(Vt, -1, -2))
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    # x1/x3 terms (Faugeras); guard near-equal singular values
    den = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / den)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / den)
    x1s = jnp.asarray([1.0, 1.0, -1.0, -1.0], H.dtype) * aux1
    x3s = jnp.asarray([1.0, -1.0, 1.0, -1.0], H.dtype) * aux3

    hyps = []
    # case d' > 0 : theta rotations about y
    sin_t = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / \
        jnp.maximum((d1 + d3) * d2, 1e-12)
    cos_t = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    for k in range(4):
        eps1, eps3 = [1, 1, -1, -1][k], [1, -1, 1, -1][k]
        st = eps1 * eps3 * sin_t
        Rp = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], H.dtype)
        Rp = Rp.at[0, 0].set(cos_t).at[0, 2].set(-st).at[2, 0].set(st).at[2, 2].set(cos_t)
        tp = (d1 - d3) * jnp.stack([x1s[k], jnp.zeros_like(d1), -x3s[k]])
        R = s * (U @ Rp @ Vt)
        t = (U @ tp[..., None])[..., 0]
        hyps.append((R, t))
    # case d' < 0 : rotations by pi about y ("phi" branch)
    sin_p = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)) / \
        jnp.maximum((d1 - d3) * d2, 1e-12)
    cos_p = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    for k in range(4):
        eps1, eps3 = [1, 1, -1, -1][k], [1, -1, 1, -1][k]
        sp = eps1 * eps3 * sin_p
        Rp = jnp.asarray([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], H.dtype)
        Rp = Rp.at[0, 0].set(cos_p).at[0, 2].set(sp).at[2, 0].set(sp).at[2, 2].set(-cos_p)
        tp = (d1 + d3) * jnp.stack([x1s[k], jnp.zeros_like(d1), x3s[k]])
        R = s * (U @ Rp @ Vt)
        t = (U @ tp[..., None])[..., 0]
        hyps.append((R, t))
    # convert x1 = R x0 + t (cam1-from-cam0) to world-from-cam1 poses
    out = []
    for R, t in hyps:
        tn = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
        Rwc = jnp.swapaxes(R, -1, -2)
        C = -(Rwc @ tn[..., None])[..., 0]
        out.append((Rwc, C))
    return out


@partial(jax.jit, static_argnames=("n_iters",))
def initialize_two_view(key, xn0, xn1, w, focal, n_iters: int = 200,
                        min_good: int = 50):
    """Full two-view bootstrap on normalized coords xn0/xn1 (N,2) with validity w.

    focal: nominal focal (px) used to express scoring thresholds in normalized
    units (scores are computed in pixel-equivalent units: err_px ~ err_n * focal).
    Returns TwoViewResult with cam0 at identity and unit baseline scale.
    """
    N = xn0.shape[0]
    dtype = xn0.dtype
    # pixel-equivalent coords for scoring parity with the reference
    uv0 = xn0 * focal
    uv1 = xn1 * focal

    # --- batched hypothesis sampling (8 points each) ---
    probs = w / jnp.maximum(jnp.sum(w), 1.0)
    idx = jax.random.categorical(
        key, jnp.log(jnp.maximum(probs, 1e-12))[None, :].repeat(n_iters * 8, 0)
    ).reshape(n_iters, 8)
    s0 = uv0[idx]                                            # (B, 8, 2)
    s1 = uv1[idx]

    # --- homography branch ---
    Hs = _dlt_homography(s0, s1)
    Hinvs = jnp.linalg.inv(Hs + 1e-12 * jnp.eye(3, dtype=dtype))
    sc_h, _ = score_homography(Hs, Hinvs, uv0[None], uv1[None], w[None])
    best_h = jnp.argmax(sc_h)
    H_best = Hs[best_h]
    score_h, inl_h = score_homography(H_best, jnp.linalg.inv(H_best), uv0, uv1, w)

    # --- fundamental branch ---
    Fs = _eight_point_f(s0, s1)
    sc_f, _ = score_fundamental(Fs, uv0[None], uv1[None], w[None])
    best_f = jnp.argmax(sc_f)
    F_best = Fs[best_f]
    score_f, inl_f = score_fundamental(F_best, uv0, uv1, w)

    rh = score_h / jnp.maximum(score_h + score_f, 1e-9)
    use_h = rh > 0.40

    # --- reconstruct both, pick by the selection rule ---
    # thresholds: 4 px^2 reprojection -> normalized (4 / focal^2)
    th_n = 4.0 / (focal * focal)
    # E from F in pixel coords: E = K^T F K with K = diag(f, f, 1)
    K = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], dtype)
    K = K.at[0, 0].set(focal).at[1, 1].set(focal)
    E = K.T @ F_best @ K
    w_f = w * inl_f
    w_h = w * inl_h

    cand = []
    for R, C in _decompose_e(E):
        Xw, good, n, _ = _check_rt(R, C, xn0, xn1, w_f, th_reproj=th_n)
        cand.append((Xw, good, n, R, C))
    # H decomposition needs the normalized-coords homography: Hn = K^-1 H K
    Kinv = jnp.linalg.inv(K)
    Hn = Kinv @ H_best @ K
    for R, C in _decompose_h_normalized(Hn):
        Xw, good, n, _ = _check_rt(R, C, xn0, xn1, w_h, th_reproj=th_n)
        cand.append((Xw, good, n, R, C))

    ns = jnp.stack([c[2] for c in cand])                     # (12,)
    is_h_cand = jnp.arange(12) >= 4
    ns_sel = jnp.where(use_h, jnp.where(is_h_cand, ns, -1),
                       jnp.where(is_h_cand, -1, ns))
    best = jnp.argmax(ns_sel)
    Xw = jnp.stack([c[0] for c in cand])[best]
    good = jnp.stack([c[1] for c in cand])[best]
    n_good = ns[best]
    R = jnp.stack([c[3] for c in cand])[best]
    C = jnp.stack([c[4] for c in cand])[best]

    # acceptance: clear winner with enough support (ReconstructF's 0.7/0.9 rules)
    ns_sorted = jnp.sort(ns_sel)
    second = ns_sorted[-2]
    ok = (n_good >= min_good) & (second.astype(dtype) < 0.75 * n_good.astype(dtype))
    return TwoViewResult(ok=ok, used_h=use_h, R=R, t=C, Xw=Xw, good=good,
                         n_good=n_good, score_h=score_h, score_f=score_f)
