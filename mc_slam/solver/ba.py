"""Concrete bundle-adjustment problems assembled on the LM + Schur engine.

Replaces the vision-only g2o graph constructions of the reference:
  * pose_only_visual  ~ Optimizer::PoseOptimization(Frame)    (src/Optimizer.cpp:3610)
  * visual_ba         ~ Optimizer::BundleAdjustment / LocalBundleAdjustment
                        (src/Optimizer.cpp:3377, 3858)
All problems are fixed-shape: padded observation tables with validity weights.
Outlier gating mirrors the reference's chi2 thresholds (5.991 for mono) but runs
as IRLS re-weighting + a final classification mask instead of graph surgery.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.solver import factors, lm

CHI2_MONO = 5.991    # 95% quantile of chi2(2), reference's mono gate
CHI2_STEREO = 7.815  # 95% quantile of chi2(3), reference's stereo gate


class VisualObs(NamedTuple):
    """Padded observation table for BA (mono rows, optional stereo third row)."""
    cam: jnp.ndarray    # (O,) int32 camera index
    pt: jnp.ndarray     # (O,) int32 point index
    uv: jnp.ndarray     # (O, 2) ideal (undistorted) pixels
    inv_sigma2: jnp.ndarray  # (O,) per-level information scale (1/1.2^(2*level))
    valid: jnp.ndarray  # (O,) {0,1}
    # observed virtual right-image u (the reference's mvuRight, mbf/z form);
    # None => purely monocular problem (2-row residuals); entries < 0 =>
    # monocular observation inside a mixed table (third row masked)
    ur: jnp.ndarray | None = None


def obs_reproj(cam: Camera, ext, P_wb, R_wb, Pw, obs: VisualObs, bf=0.0):
    """Dispatch mono 2-row / mixed 3-row reprojection for an observation batch.
    Returns (r, J_pr, J_pt, z, delta2) with delta2 the per-obs huber knee."""
    if obs.ur is None:
        r, J_pr, J_pt, z = factors.reproj_xyz(cam, ext, P_wb, R_wb, Pw, obs.uv)
        return r, J_pr, J_pt, z, CHI2_MONO
    r, J_pr, J_pt, z = factors.reproj_xyz3(cam, ext, P_wb, R_wb, Pw, obs.uv,
                                           obs.ur, bf)
    delta2 = jnp.where(obs.ur >= 0, CHI2_STEREO, CHI2_MONO)
    return r, J_pr, J_pt, z, delta2


class VisualBAConfig(NamedTuple):
    iters: int = 10
    huber_delta2: float = CHI2_MONO
    lam0: float = 1e-4


def _obs_weights(r, z, inv_sigma2, valid, delta2):
    """Robust scalar weight per obs: info * trunc-huber(chi2) * valid * (z > 0).

    The kernel is TRUNCATED (lm.HUBER_TRUNC): gross outliers get zero
    influence, the jit-friendly equivalent of the reference deleting
    chi2>5.991 edges between rounds (src/Optimizer.cpp:1920-1980)."""
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    w_rob = lm.trunc_huber_weight(chi2, delta2)
    pos = (z > 1e-6).astype(r.dtype)
    return inv_sigma2 * w_rob * valid * pos, chi2


def _robust_cost(r, z, inv_sigma2, valid, delta2):
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    pos = (z > 1e-6).astype(r.dtype)
    rho = lm.trunc_huber_cost(chi2, delta2)
    # out-of-frustum observations sit exactly ON the truncation plateau:
    # pushing a point behind a camera can never lower the cost, and a gross
    # in-view outlier costs the same as an invisible one — see lm.HUBER_TRUNC
    # for the failure mode an unbounded kernel causes here
    rho = jnp.where(pos > 0, rho, jnp.broadcast_to(lm.trunc_plateau(delta2),
                                                   rho.shape))
    return jnp.sum(valid * rho)


# ---------------------------------------------------------------------------
# Pose-only optimization (tracking hot path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("iters", "rtol"))
def pose_only_visual(P0, R0, pts_w, obs: VisualObs, camera: Camera,
                     ext: factors.Extrinsics, iters: int = 40,
                     huber_delta2: float = CHI2_MONO, bf=0.0,
                     rtol: float = 0.0):
    """Optimize a single body pose against fixed world points.

    P0 (3,), R0 (3,3); pts_w (Np,3) fixed. obs.cam is ignored (single pose).
    When obs.ur is set, stereo/RGB-D observations add the u_right residual row
    (bf = fx * baseline). Returns (P, R, chi2 (O,), n_inlier).
    """
    pts_o = pts_w[obs.pt]

    def per_obs(P, R):
        return obs_reproj(camera, ext, P, R, pts_o, obs, bf)

    def retract(x, dx):
        P, R = x
        return (P + dx[:3], R @ lie.so3_exp(dx[3:6]))

    def make_fns(valid):
        def cost_fn(x):
            r, _, _, z, d2 = per_obs(*x)
            return _robust_cost(r, z, obs.inv_sigma2, valid, d2)

        def linearize_solve(x, lam):
            r, J_pr, _, z, d2 = per_obs(*x)
            w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
            H = jnp.einsum('o,orc,ord->cd', w, J_pr, J_pr)
            g = jnp.einsum('o,orc,or->c', w, J_pr, r)
            H = H + jnp.diag(lam * jnp.diagonal(H) + 1e-10)
            L, low = jax.scipy.linalg.cho_factor(H, lower=True)
            return jax.scipy.linalg.cho_solve((L, low), -g)

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        # chi2 gate at the knee, as the reference's per-round outlier
        # re-classification (mono 5.991 / stereo 7.815, Optimizer.cpp:1920-1980)
        r, _, _, z, d2 = per_obs(*x)
        chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).astype(valid0.dtype)

    # single LM run: the reference's 4-round chi2 re-classification
    # (Optimizer.cpp:3610) is realized one level UP here — the tracking
    # kernels run two full search->optimize rounds with RE-MATCHING in
    # between (tracking.track_frame_visual one_round x2), which is a
    # stronger reclassification than re-gating a fixed match set; the
    # truncated kernel (lm.HUBER_TRUNC) zeroes gross outliers within a run.
    (P, R), cost, _ = lm.lm_two_phase((P0, R0), make_fns, obs.valid, classify,
                                      iters, p1_frac=0.5, rtol=rtol,
                                      enable=False)
    r, _, _, z, d2 = per_obs(P, R)
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    inlier = (chi2 <= d2) & (z > 0) & (obs.valid > 0)
    return P, lie.so3_normalize_fast(R), chi2, jnp.sum(inlier)


# ---------------------------------------------------------------------------
# Full visual BA with landmark Schur complement
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("iters", "rtol", "two_phase"))
def visual_ba(P0, R0, pts0, obs: VisualObs, camera: Camera, ext: factors.Extrinsics,
              free_cam, pt_mask, iters: int = 10, huber_delta2: float = CHI2_MONO,
              lam0: float = 1e-4, bf=0.0, rtol: float = 0.0,
              two_phase: bool = True):
    """Joint camera + landmark BA.

    P0 (Nc,3), R0 (Nc,3,3), pts0 (Np,3). free_cam (Nc,) float {0,1}; pt_mask (Np,).
    When obs.ur is set, stereo/RGB-D rows constrain metric scale (bf = fx *
    baseline). Returns (P, R, pts, chi2 (O,), final_cost).
    """
    Nc, Np = P0.shape[0], pts0.shape[0]
    DC, DP = 6, 3

    def per_obs(x):
        P, R, pts = x
        return obs_reproj(camera, ext, P[obs.cam], R[obs.cam], pts[obs.pt], obs, bf)

    def retract(x, dx):
        P, R, pts = x
        dxc, dxp = dx
        return (P + dxc[:, :3], R @ lie.so3_exp(dxc[:, 3:6]), pts + dxp)

    def make_fns(valid):
        def cost_fn(x):
            r, _, _, z, d2 = per_obs(x)
            return _robust_cost(r, z, obs.inv_sigma2, valid, d2)

        def linearize_solve(x, lam):
            r, J_pr, J_pt, z, d2 = per_obs(x)
            w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
            o = lm.Observations(cam=obs.cam[:, None], pt=obs.pt,
                                Jc=J_pr[:, None], Jp=J_pt, r=r, w=w)
            Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(
                o, free_cam, Nc, DC, Np, DP)
            dxc, dxp = lm.schur_solve(Hcc, g_c, Hpp, g_p, Wcp, lam, free_cam,
                                      pt_mask)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        r, _, _, z, d2 = per_obs(x)
        chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).astype(valid0.dtype)

    (P, R, pts), cost, _ = lm.lm_two_phase(
        (P0, R0, pts0), make_fns, obs.valid, classify, iters, lam0=lam0,
        rtol=rtol, enable=two_phase)
    R = lie.so3_normalize_fast(R)
    r, _, _, z, _ = per_obs((P, R, pts))
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    chi2 = jnp.where(z > 0, chi2, jnp.full_like(chi2, 1e9))
    return P, R, pts, chi2, cost
