"""Visual-inertial optimizers on the LM + Schur engine.

Replaces the reference's VI g2o graphs:
  * pose_only_vi      ~ Optimizer::PoseOptimization(Frame, Frame|KeyFrame, preint,
                        gw, bComputeMarg)  (src/Optimizer.cpp:1671-2041) including
                        the 15x15 marginal information prior for the next frame
                        (src/Optimizer.cpp:1997-2014, computeMarginals).
  * vi_ba             ~ Optimizer::LocalBundleAdjustmentNavStatePRV (:937) /
                        GlobalBundleAdjustmentNavStatePRV (:629): sliding-window or
                        full-map BA over 15d NavStates with the IMU PRV chain,
                        bias random-walk edges, and XYZ reprojection.

State layout per keyframe (DC = 15): [dP(0:3), dphi(3:6), dV(6:9), ddbg(9:12),
ddba(12:15)] with the NavState retraction (right-multiplicative rotation).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.imu.navstate import NavState
from mc_slam.imu.preintegration import PreintState
from mc_slam.solver import factors, lm
from mc_slam.solver.ba import (CHI2_MONO, VisualObs, _obs_weights,
                                   _robust_cost, obs_reproj)

DC = 15


class IMUEdges(NamedTuple):
    """PRV chain + bias random-walk edges between keyframe pairs (i -> j)."""
    i: jnp.ndarray        # (E,) int32
    j: jnp.ndarray        # (E,) int32
    pre: PreintState      # batched (E, ...) preintegration i->j
    info_prv: jnp.ndarray  # (E, 9, 9)
    info_bias: jnp.ndarray  # (E, 6, 6)
    valid: jnp.ndarray    # (E,)


class PriorFactor(NamedTuple):
    """15d prior on one keyframe (order [P, phi, V, dbg, dba])."""
    cam: jnp.ndarray      # () int32
    ns0: NavState         # linearization point (single state)
    info: jnp.ndarray     # (15, 15)
    valid: jnp.ndarray    # ()


def retract_states(ns: NavState, dx) -> NavState:
    return ns._replace(
        P=ns.P + dx[..., 0:3],
        R=ns.R @ lie.so3_exp(dx[..., 3:6]),
        V=ns.V + dx[..., 6:9],
        dbg=ns.dbg + dx[..., 9:12],
        dba=ns.dba + dx[..., 12:15],
    )


def _reproj_cam_jac_embed(J_pr):
    """(…,2,6) PR Jacobian -> (…,2,15) full-state block (V/bias columns zero)."""
    pad = jnp.zeros(J_pr.shape[:-1] + (9,), J_pr.dtype)
    return jnp.concatenate([J_pr, pad], axis=-1)


def _imu_edge_factors(ns: NavState, edges: IMUEdges, gw):
    """Evaluate PRV + bias-RW residuals/Jacobians for all edges.

    Returns two lm.CamFactors batches (K=2 camera blocks each).
    """
    i, j = edges.i, edges.j
    r, J_pri, J_prj, J_vi, J_vj, J_bi = factors.imu_prv(
        ns.P[i], ns.R[i], ns.V[i], ns.dbg[i], ns.dba[i],
        ns.P[j], ns.R[j], ns.V[j], edges.pre, gw)
    E = i.shape[0]
    Z96 = jnp.zeros((E, 9, 6), r.dtype)
    J_i = jnp.concatenate([J_pri, J_vi, J_bi], axis=-1)          # (E,9,15)
    J_j = jnp.concatenate([J_prj, J_vj, Z96], axis=-1)           # (E,9,15)
    prv = lm.CamFactors(
        cam=jnp.stack([i, j], axis=-1), J=jnp.stack([J_i, J_j], axis=1),
        r=r, info=edges.info_prv, w=edges.valid)

    r_b = factors.bias_rw(ns.bg[i] + ns.dbg[i], ns.ba[i] + ns.dba[i],
                          ns.bg[j] + ns.dbg[j], ns.ba[j] + ns.dba[j])
    I6 = jnp.broadcast_to(jnp.eye(6, dtype=r.dtype), (E, 6, 6))
    Z69 = jnp.zeros((E, 6, 9), r.dtype)
    Jb_i = jnp.concatenate([Z69, -I6], axis=-1)
    Jb_j = jnp.concatenate([Z69, I6], axis=-1)
    bias = lm.CamFactors(
        cam=jnp.stack([i, j], axis=-1), J=jnp.stack([Jb_i, Jb_j], axis=1),
        r=r_b, info=edges.info_bias, w=edges.valid)
    return prv, bias


def _prior_factor(ns: NavState, prior: PriorFactor):
    c = prior.cam
    r, J = factors.prior_pr_v_bias(
        ns.P[c], ns.R[c], ns.V[c], ns.dbg[c], ns.dba[c],
        prior.ns0.P, prior.ns0.R, prior.ns0.V, prior.ns0.dbg, prior.ns0.dba)
    return lm.CamFactors(
        cam=c[None, None], J=J[None, None], r=r[None],
        info=prior.info[None], w=prior.valid[None])


def _vi_total_cost(ns: NavState, pts, obs: VisualObs, edges: IMUEdges,
                   prior, camera, ext, gw, huber_delta2, bf=0.0):
    r, _, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                pts[obs.pt], obs, bf)
    c = _robust_cost(r, z, obs.inv_sigma2, obs.valid, d2)
    prv, bias = _imu_edge_factors(ns, edges, gw)
    c = c + jnp.sum(prv.w * jnp.einsum('er,ers,es->e', prv.r, prv.info, prv.r))
    c = c + jnp.sum(bias.w * jnp.einsum('er,ers,es->e', bias.r, bias.info, bias.r))
    if prior is not None:
        pf = _prior_factor(ns, prior)
        c = c + jnp.sum(pf.w * jnp.einsum('er,ers,es->e', pf.r, pf.info, pf.r))
    return c


def _build_H_cam(ns, pts, obs, edges, prior, camera, ext, gw, free_mask, huber_delta2,
                 Nc):
    """Dense camera-system H, g from all factors (landmark part returned separately)."""
    dtype = ns.P.dtype
    H = jnp.zeros((Nc, DC, Nc, DC), dtype)
    g = jnp.zeros((Nc, DC), dtype)
    cost = jnp.zeros((), dtype)
    prv, bias = _imu_edge_factors(ns, edges, gw)
    H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free_mask)
    H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free_mask)
    if prior is not None:
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, _prior_factor(ns, prior), free_mask)
    return H, g


@partial(jax.jit, static_argnames=("iters", "fix_points", "rtol", "two_phase"))
def vi_ba(ns0: NavState, pts0, obs: VisualObs, edges: IMUEdges, camera: Camera,
          ext: factors.Extrinsics, gw, free_cam, pt_mask,
          prior: PriorFactor | None = None, iters: int = 10,
          huber_delta2: float = CHI2_MONO, lam0: float = 1e-4,
          fix_points: bool = False, bf=0.0, rtol: float = 0.0,
          two_phase: bool = True):
    """Windowed/global VI bundle adjustment over NavStates + XYZ landmarks.

    ns0: NavState with (Nc,…) arrays (window KFs + fixed neighbors/observers).
    pts0 (Np,3). free_cam (Nc,), pt_mask (Np,). Returns (ns, pts, chi2_obs, cost).

    fix_points=True turns this into multi-frame pose-only optimization (used by
    the relocalization bias recompute, src/Tracking.cpp:47-220).
    """
    Nc = ns0.P.shape[0]
    Np, DP = pts0.shape[0], 3

    def retract(x, dx):
        ns, pts = x
        dxc, dxp = dx
        return retract_states(ns, dxc), pts + dxp

    def make_fns(valid):
        vobs = obs._replace(valid=valid)

        def cost_fn(x):
            ns, pts = x
            return _vi_total_cost(ns, pts, vobs, edges, prior, camera, ext, gw,
                                  huber_delta2, bf)

        def linearize_solve(x, lam):
            ns, pts = x
            r, J_pr, J_pt, z, d2 = obs_reproj(
                camera, ext, ns.P[obs.cam], ns.R[obs.cam], pts[obs.pt], obs, bf)
            w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
            # build the visual system in 6-d PR space; embed into the 15-d VI
            # system once (reprojection has zero V/bias columns — padding them
            # into the block outer products costs ~6x for nothing)
            o = lm.Observations(cam=obs.cam[:, None], pt=obs.pt,
                                Jc=J_pr[:, None], Jp=J_pt, r=r, w=w)
            Hcc6, g6, Hpp, g_p, Wcp6, _ = lm.build_landmark_system(
                o, free_cam, Nc, 6, Np, DP)
            Hf, gf = _build_H_cam(ns, pts, vobs, edges, prior, camera, ext, gw,
                                  free_cam, huber_delta2, Nc)
            H = Hf.at[:, :6, :, :6].add(Hcc6)
            g = gf.at[:, :6].add(g6)
            if fix_points:
                dxc = lm.solve_cam_system(H, g, lam, free_cam)
                return dxc, jnp.zeros_like(pts)
            dxc, dxp = lm.schur_solve_pr(H, g, Hpp, g_p, Wcp6, lam, free_cam,
                                         pt_mask)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        ns, pts = x
        r, _, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                    pts[obs.pt], obs, bf)
        chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).astype(valid0.dtype)

    (ns, pts), cost, _ = lm.lm_two_phase(
        (ns0, pts0), make_fns, obs.valid, classify, iters, lam0=lam0,
        rtol=rtol, enable=two_phase)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))
    r, _, _, z, _ = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                               pts[obs.pt], obs, bf)
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    chi2 = jnp.where(z > 0, chi2, jnp.full_like(chi2, 1e9))
    return ns, pts, chi2, cost


@partial(jax.jit, static_argnames=("iters", "compute_marg", "rtol"))
def pose_only_vi(ns_cur0: NavState, ns_last: NavState, pre_last_cur: PreintState,
                 pts_w, obs: VisualObs, camera: Camera, ext: factors.Extrinsics,
                 gw, prior_last: PriorFactor, info_prv, info_bias,
                 iters: int = 40, huber_delta2: float = CHI2_MONO,
                 compute_marg: bool = True, bf=0.0, rtol: float = 0.0):
    """Tracking-time VI pose optimization of (last, current) frame pair.

    Mirrors Optimizer::PoseOptimization (src/Optimizer.cpp:1671-2041): both frames
    are free, tied by the IMU PRV + bias edges; the last frame is held by its
    marginalization prior; map points are fixed. Returns
    (ns_cur, chi2 (O,), n_inliers, H_marg (15,15)) where H_marg is the marginal
    information of the current frame (the next frame's prior), obtained by Schur-
    eliminating the last frame from the final normal equations.
    """
    Nc = 2  # state 0 = last, state 1 = current
    ns0 = jax.tree_util.tree_map(lambda a, b: jnp.stack([a, b]), ns_last, ns_cur0)
    edges = IMUEdges(i=jnp.asarray([0], jnp.int32), j=jnp.asarray([1], jnp.int32),
                     pre=jax.tree_util.tree_map(lambda a: a[None], pre_last_cur),
                     info_prv=info_prv[None], info_bias=info_bias[None],
                     valid=jnp.ones(1, ns_cur0.P.dtype))
    obs = obs._replace(cam=jnp.ones_like(obs.cam))  # all obs on the current frame
    free = jnp.ones(2, ns_cur0.P.dtype)
    pts_o = pts_w[obs.pt]

    def build(ns, valid):
        r, J_pr, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                       pts_o, obs, bf)
        w, _ = _obs_weights(r, z, obs.inv_sigma2, valid, d2)
        wJ = J_pr * w[:, None, None]
        H = jnp.zeros((Nc, DC, Nc, DC), r.dtype)
        g = jnp.zeros((Nc, DC), r.dtype)
        # all obs are on cam 1; reprojection touches only the 6-d PR block
        H = H.at[1, :6, 1, :6].add(jnp.einsum('orc,ord->cd', wJ, J_pr))
        g = g.at[1, :6].add(jnp.einsum('orc,or->c', wJ, r))
        cost = jnp.zeros((), r.dtype)
        prv, bias = _imu_edge_factors(ns, edges, gw)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, _prior_factor(ns, prior_last), free)
        return H, g

    def make_fns(valid):
        vobs = obs._replace(valid=valid)

        def cost_fn(ns):
            return _vi_total_cost(ns, pts_w, vobs, edges, prior_last, camera,
                                  ext, gw, huber_delta2, bf)

        def linearize_solve(ns, lam):
            H, g = build(ns, valid)
            return lm.solve_cam_system(H, g, lam, free)

        return linearize_solve, retract_states, cost_fn

    def classify(ns, valid0):
        r, _, _, z, d2 = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                    pts_o, obs, bf)
        chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= d2) & (z > 1e-6)).astype(valid0.dtype)

    # single LM run: the reference's 4x10 per-round chi2 gating
    # (Optimizer.cpp:1920-1980) is realized one level up — track_frame_vi
    # runs two search->optimize rounds with RE-MATCHING between them, and
    # the truncated kernel zeroes gross outliers within a run. An in-solver
    # re-classification round here measurably degrades weakly-observed bias
    # axes (optical-axis gyro bias) during the post-reloc window, where the
    # IMU side is corrupt by construction and the pruned visual residuals
    # are exactly the signal exposing it.
    ns, cost, _ = lm.lm_two_phase(ns0, make_fns, obs.valid, classify, iters,
                                  p1_frac=0.5, rtol=rtol, enable=False)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))

    r, _, _, z, d2_f = obs_reproj(camera, ext, ns.P[obs.cam], ns.R[obs.cam],
                                  pts_o, obs, bf)
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    inlier = (chi2 <= d2_f) & (z > 0) & (obs.valid > 0)

    if compute_marg:
        # marginal information of the current frame: Schur out the last frame
        # (built from the final inlier classification)
        H, _ = build(ns, classify(ns, obs.valid))
        Hll = H[0, :, 0, :] + 1e-8 * jnp.eye(DC, dtype=H.dtype)
        Hlc = H[0, :, 1, :]
        Hcc = H[1, :, 1, :]
        H_marg = Hcc - Hlc.T @ jnp.linalg.solve(Hll, Hlc)
    else:
        H_marg = jnp.zeros((DC, DC), ns.P.dtype)

    ns_cur = jax.tree_util.tree_map(lambda a: a[1], ns)
    return ns_cur, chi2, jnp.sum(inlier), H_marg
