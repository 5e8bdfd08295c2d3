"""Tracking-stage device kernels (jitted, fixed-shape).

Replaces the per-frame logic of Tracking (src/Tracking.cpp): map-point projection
search + pose optimization (TrackWithMotionModel :1735 / TrackLocalMap :1813 and
the IMU variants :224-412), fused into two search→optimize rounds against the
whole active map (the reference's "local map" subset is a CPU-cache trick; on
the device projecting every active point is one batched op).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.frontend import matching
from mc_slam.frontend.extractor import Features
from mc_slam.slam_map.mapstate import MapState
from mc_slam.solver import ba, ba_vi, factors
from mc_slam.solver.ba import VisualObs


class TrackResult(NamedTuple):
    P: jnp.ndarray           # (3,) optimized body position
    R: jnp.ndarray           # (3,3)
    feat_mp: jnp.ndarray     # (F,) int32 map-point index per feature (-1 none)
    n_matches: jnp.ndarray   # () int32 matches fed to the optimizer
    n_inliers: jnp.ndarray   # () int32 chi2-inliers after optimization


def project_map_points(m: MapState, cam: Camera, ext: factors.Extrinsics, P, R):
    """Project all active map points into the frame at body pose (P, R).
    Returns (uv (Pn,2), z (Pn,), visible (Pn,) bool) — isInFrustum
    (src/Frame.cpp:492) including the viewing-cone test."""
    RwbT = jnp.swapaxes(R, -1, -2)
    Pb = (RwbT @ (m.mp_pos - P)[..., None])[..., 0]
    Pc = (ext.Rcb @ Pb[..., None])[..., 0] + ext.tcb
    z = Pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Pc[..., 0] / z_safe + cam.cx
    v = cam.fy * Pc[..., 1] / z_safe + cam.cy
    vis = (z > 0.1) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) \
        & m.mp_active
    # scale-invariance distance gate (MapPoint::PredictScale region)
    dist = jnp.linalg.norm(Pb, axis=-1)
    vis = vis & (dist >= 0.5 * m.mp_min_dist) & (dist <= 1.5 * jnp.maximum(m.mp_max_dist, 1e-6))
    # viewing-cone gate (isInFrustum: viewCos = PO.normal/dist > 0.5,
    # src/Frame.cpp:492): reject points seen from >60 deg off their mean
    # observation aspect — the descriptor aliases under large aspect change,
    # and this is the reference's outlier filter for the local-map search
    # (which has no rotation-histogram check, ORBmatcher.cpp:63).
    Cw = P - (R @ (jnp.swapaxes(ext.Rcb, -1, -2) @ ext.tcb[..., None]))[..., 0]
    dir_w = m.mp_pos - Cw
    view_cos = jnp.sum(dir_w * m.mp_normal, -1) \
        / jnp.maximum(jnp.linalg.norm(dir_w, axis=-1), 1e-9)
    # a zero normal means "no aspect statistics yet" (empty_map init,
    # hand-built maps): skip the cone test for those points
    has_normal = jnp.sum(m.mp_normal * m.mp_normal, -1) > 0.25
    vis = vis & ((view_cos > 0.5) | ~has_normal)
    return jnp.stack([u, v], -1), z, vis


def last_frame_angles(m: MapState, prev_feat_mp, prev_angle):
    """Scatter the previous frame's keypoint angles onto map-point slots.

    Rotation consistency needs every `angle_a` measured in ONE orientation;
    the map-point representative angle (which travels with the distinctive
    descriptor across observer KFs) does not satisfy that, but the angle of
    each point's observation in the immediately previous frame does — this is
    exactly the reference's SearchByProjection(CurrentFrame, LastFrame)
    rotHist source (src/ORBmatcher.cpp:1511). Points unseen last frame get
    participate=False and skip the prune, like the reference's un-checked
    local-map search (ORBmatcher.cpp:63). A slot recycled between frames can
    carry a stale angle for one frame; the histogram absorbs it as noise."""
    tgt = jnp.where(prev_feat_mp >= 0, prev_feat_mp, m.P)
    angle = jnp.zeros((m.P,), prev_angle.dtype).at[tgt].set(
        prev_angle, mode="drop")
    seen = jnp.zeros((m.P,), bool).at[tgt].set(True, mode="drop")
    return angle, seen


def predict_level(m: MapState, P, dist_scale=1.2, n_levels=8):
    """Predicted pyramid level from distance (MapPoint::PredictScale)."""
    d = jnp.linalg.norm(m.mp_pos - P, axis=-1)
    ratio = jnp.maximum(m.mp_max_dist, 1e-6) / jnp.maximum(d, 1e-6)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-6)) / jnp.log(dist_scale))
    return jnp.clip(lvl, 0, n_levels - 1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("iters", "rtol"))
def track_frame_visual(m: MapState, feats: Features, uv_ideal, cam: Camera,
                       ext: factors.Extrinsics, P0, R0, radius_coarse=15.0,
                       radius_fine=4.0, iters: int = 20, inv_sigma2=None,
                       feat_ur=None, bf=0.0, rtol: float = 0.0,
                       prev_feat_mp=None, prev_angle=None):
    """Two-round project→match→optimize against the active map.

    uv_ideal: (F,2) undistorted feature pixels. feat_ur: optional (F,) observed
    virtual-right u per feature (stereo/RGB-D; <0 = no depth) — adds the
    u_right residual row to pose optimization (bf = fx * baseline).
    Returns TrackResult.
    """
    Fn = feats.valid.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = 1.0 / (1.2 ** (2.0 * feats.level.astype(jnp.float32)))
    if prev_feat_mp is not None:
        mp_last_angle, mp_seen_last = last_frame_angles(m, prev_feat_mp,
                                                        prev_angle)
    else:
        mp_last_angle = mp_seen_last = None

    def one_round(P, R, radius, lam_iters):
        proj_uv, z, vis = project_map_points(m, cam, ext, P, R)
        lvl = predict_level(m, P)
        mp_idx, dist, ok = matching.search_by_projection(
            proj_uv, vis, lvl, m.mp_pm1, uv_ideal, feats.level, feats.desc_pm1,
            feats.valid, radius_px=radius,
            proj_angle=mp_last_angle, feat_angle=feats.angle,
            proj_angle_valid=mp_seen_last)
        # rotation consistency runs ONLY against last-frame observation
        # angles (see last_frame_angles); map-point representative angles are
        # never used here — the reference's local-map search has no rotation
        # check (ORBmatcher.cpp:63) and its aspect filter is the viewing-cone
        # test in project_map_points.
        # per-feature association: invert (map-point -> feature) to (feature -> mp)
        feat_mp = jnp.full((Fn,), -1, jnp.int32)
        src = jnp.arange(m.P, dtype=jnp.int32)
        # scatter only accepted matches (not-ok entries target an out-of-range
        # slot and are dropped); duplicates are already resolved per feature
        feat_mp = feat_mp.at[jnp.where(ok, mp_idx, Fn)].set(src, mode="drop")
        matched = feat_mp >= 0
        obs = VisualObs(
            cam=jnp.zeros(Fn, jnp.int32),
            pt=jnp.clip(feat_mp, 0, m.P - 1),
            uv=uv_ideal,
            inv_sigma2=inv_sigma2,
            valid=matched.astype(jnp.float32),
            ur=feat_ur)
        Pn, Rn, chi2, n_in = ba.pose_only_visual(P, R, m.mp_pos, obs, cam, ext,
                                                 iters=lam_iters, bf=bf,
                                                 rtol=rtol)
        gate = ba.CHI2_MONO if feat_ur is None else \
            jnp.where(feat_ur >= 0, ba.CHI2_STEREO, ba.CHI2_MONO)
        inlier = matched & (chi2 <= gate)
        return Pn, Rn, jnp.where(inlier, feat_mp, -1), jnp.sum(matched), n_in

    P1, R1, fmp1, nm1, ni1 = one_round(P0, R0, radius_coarse, iters)
    P2, R2, fmp2, nm2, ni2 = one_round(P1, R1, radius_fine, iters)
    return TrackResult(P=P2, R=R2, feat_mp=fmp2, n_matches=nm2, n_inliers=ni2)


@partial(jax.jit, static_argnames=("iters", "rtol"))
def track_frame_visual_step(m: MapState, feats: Features, uv_ideal, cam: Camera,
                            ext: factors.Extrinsics, P_last, R_last, dP, dR,
                            iters: int = 20, feat_ur=None, bf=0.0,
                            rtol: float = 0.0,
                            prev_feat_mp=None, prev_angle=None):
    """Fused per-frame visual step: velocity-model prediction +
    track_frame_visual + velocity update + found/visible counters in one
    program; the host pulls only n_inliers (each pull is a device round trip
    the host loop waits out).

    dP/dR: the constant-velocity model in the last frame's body frame
    (src/Tracking.cpp:1123-1134). Returns (res, (dP', dR'), mp_found,
    mp_visible)."""
    P0 = P_last + (R_last @ dP[..., None])[..., 0]
    R0 = R_last @ dR
    res = track_frame_visual(m, feats, uv_ideal, cam, ext, P0, R0,
                             iters=iters, feat_ur=feat_ur, bf=bf, rtol=rtol,
                             prev_feat_mp=prev_feat_mp, prev_angle=prev_angle)
    RlT = jnp.swapaxes(R_last, -1, -2)
    vel = ((RlT @ (res.P - P_last)[..., None])[..., 0], RlT @ res.R)
    vis = jnp.zeros(m.P, bool).at[
        jnp.clip(res.feat_mp, 0, m.P - 1)].set(res.feat_mp >= 0, mode="drop")
    fv = vis.astype(m.mp_found.dtype)
    return res, vel, m.mp_found + fv, m.mp_visible + fv


@partial(jax.jit, static_argnames=("iters", "rtol"))
def track_frame_vi(m: MapState, feats: Features, uv_ideal, cam: Camera,
                   ext: factors.Extrinsics, ns_cur0, ns_last, pre_last_cur,
                   gw, prior_last: ba_vi.PriorFactor, radius_coarse=15.0,
                   radius_fine=4.0, iters: int = 20,
                   sigma_bg=2e-5, sigma_ba=5e-3, feat_ur=None, bf=0.0,
                   rtol: float = 0.0, prev_feat_mp=None, prev_angle=None):
    """VI tracking: IMU-predicted pose, projection search, joint (last,cur)
    optimization with IMU + prior factors, marginal extraction
    (TrackWithIMU + TrackLocalMapWithIMU, src/Tracking.cpp:224-412).
    sigma_bg/sigma_ba: the system's configured bias random-walk densities
    (IMUNoise; EuRoC defaults per src/IMU/imudata.cpp:25-37)."""
    Fn = feats.valid.shape[0]
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * feats.level.astype(jnp.float32)))
    info_prv = factors.imu_prv_info(pre_last_cur)
    info_bias = factors.bias_rw_info(pre_last_cur.dT, sigma_bg, sigma_ba)
    if prev_feat_mp is not None:
        mp_last_angle, mp_seen_last = last_frame_angles(m, prev_feat_mp,
                                                        prev_angle)
    else:
        mp_last_angle = mp_seen_last = None

    def search(P, R, radius):
        proj_uv, z, vis = project_map_points(m, cam, ext, P, R)
        lvl = predict_level(m, P)
        mp_idx, dist, ok = matching.search_by_projection(
            proj_uv, vis, lvl, m.mp_pm1, uv_ideal, feats.level, feats.desc_pm1,
            feats.valid, radius_px=radius,
            proj_angle=mp_last_angle, feat_angle=feats.angle,
            proj_angle_valid=mp_seen_last)
        # rotation consistency runs ONLY against last-frame observation
        # angles (see last_frame_angles); map-point representative angles are
        # never used here — the reference's local-map search has no rotation
        # check (ORBmatcher.cpp:63) and its aspect filter is the viewing-cone
        # test in project_map_points.
        feat_mp = jnp.full((Fn,), -1, jnp.int32)
        src = jnp.arange(m.P, dtype=jnp.int32)
        # scatter only accepted matches (not-ok entries target an out-of-range
        # slot and are dropped); duplicates are already resolved per feature
        feat_mp = feat_mp.at[jnp.where(ok, mp_idx, Fn)].set(src, mode="drop")
        matched = feat_mp >= 0
        return VisualObs(cam=jnp.zeros(Fn, jnp.int32),
                         pt=jnp.clip(feat_mp, 0, m.P - 1), uv=uv_ideal,
                         inv_sigma2=inv_sigma2,
                         valid=matched.astype(jnp.float32),
                         ur=feat_ur), feat_mp, matched

    obs1, _, _ = search(ns_cur0.P, ns_cur0.R, radius_coarse)
    ns1, chi2_1, nin1, _ = ba_vi.pose_only_vi(
        ns_cur0, ns_last, pre_last_cur, m.mp_pos, obs1, cam, ext, gw,
        prior_last, info_prv, info_bias, iters=iters, compute_marg=False,
        bf=bf, rtol=rtol)
    obs2, feat_mp, matched = search(ns1.P, ns1.R, radius_fine)
    ns2, chi2, n_in, H_marg = ba_vi.pose_only_vi(
        ns1, ns_last, pre_last_cur, m.mp_pos, obs2, cam, ext, gw,
        prior_last, info_prv, info_bias, iters=iters, compute_marg=True,
        bf=bf, rtol=rtol)
    gate = ba.CHI2_MONO if feat_ur is None else \
        jnp.where(feat_ur >= 0, ba.CHI2_STEREO, ba.CHI2_MONO)
    inlier = matched & (chi2 <= gate)
    return ns2, jnp.where(inlier, feat_mp, -1), jnp.sum(matched), n_in, H_marg


@partial(jax.jit, static_argnames=("iters", "rtol"))
def track_frame_vi_step(m: MapState, feats: Features, uv_ideal, cam: Camera,
                        ext: factors.Extrinsics, rawp, noise, ns_last,
                        gw, prior_last: ba_vi.PriorFactor,
                        iters: int = 20, sigma_bg=2e-5, sigma_ba=5e-3,
                        feat_ur=None, bf=0.0,
                        bias_jump_bg=0.05, bias_jump_ba=0.5, rtol: float = 0.0,
                        prev_feat_mp=None, prev_angle=None):
    """One fused per-frame VI tracking step: IMU preintegration + NavState
    prediction + track_frame_vi plus everything the host orchestrator needs
    afterwards — the bias-jump sanity flag, the symmetrized/floored marginal
    prior, and the found/visible counter update — ONE device dispatch and ONE
    tiny summary pull per frame (each extra eager op / host sync is a full
    device round trip).

    rawp: (T,7) zero-padded [gyro, acc, dt] rows since the last frame.
    noise: IMUNoise. Returns (ns2, feat_mp, H_prior, mp_found, mp_visible,
    summary) with summary = [n_inliers, bias_jump] as float32; the counter
    arrays are only valid if the host accepts this result (no fallback)."""
    from mc_slam.imu.preintegration import predict_navstate, preintegrate
    pre_last_cur = preintegrate(rawp, ns_last.bg_full, ns_last.ba_full, noise)
    ns_cur0 = predict_navstate(ns_last, pre_last_cur, gw)
    ns2, feat_mp, n_m, n_in, H_marg = track_frame_vi(
        m, feats, uv_ideal, cam, ext, ns_cur0, ns_last, pre_last_cur, gw,
        prior_last, iters=iters, sigma_bg=sigma_bg, sigma_ba=sigma_ba,
        feat_ur=feat_ur, bf=bf, rtol=rtol,
        prev_feat_mp=prev_feat_mp, prev_angle=prev_angle)
    # per-frame bias-step sanity (see SlamSystem._track_frame_vi): the random
    # walk allows ~1e-3 between frames; far beyond that = poisoned solve
    bias_jump = ((jnp.max(jnp.abs(ns2.dbg - ns_last.dbg)) > bias_jump_bg)
                 | (jnp.max(jnp.abs(ns2.dba - ns_last.dba)) > bias_jump_ba))
    H_prior = (0.5 * (H_marg + H_marg.T)
               + 1e-3 * jnp.eye(15, dtype=H_marg.dtype))
    vis = jnp.zeros(m.P, bool).at[
        jnp.clip(feat_mp, 0, m.P - 1)].set(feat_mp >= 0, mode="drop")
    fv = vis.astype(m.mp_found.dtype)
    summary = jnp.stack([n_in.astype(jnp.float32),
                         bias_jump.astype(jnp.float32)])
    return ns2, feat_mp, H_prior, m.mp_found + fv, m.mp_visible + fv, summary


@jax.jit
def reloc_candidates_batch(m: MapState, cand_slots, keys, desc_pm1,
                           feat_valid, feat_angle, xn, focal):
    """Relocalization candidate evaluation for C keyframes as ONE device
    program: mutual descriptor match against each candidate's landmark
    features + PnP RANSAC (Tracking::Relocalization's per-candidate loop,
    src/Tracking.cpp:2388-2566). The host-loop form cost ~6 round trips PER
    candidate, and relocalization runs at frame rate while lost.

    Returns (C, 15) packed rows [n_match, pnp_ok, pnp_inliers, R_cw(9),
    t_cw(3)]; ONE host pull decides which candidate (if any) to refine."""
    from mc_slam.geometry import pnp as _pnp

    def one(k, key):
        mp_k = m.kf_mp[k]
        has = (mp_k >= 0) & m.kf_feat_valid[k]
        idx, best, okm = matching.mutual_match(
            desc_pm1, feat_valid, m.kf_pm1[k], has,
            max_dist=matching.TH_LOW, ratio=0.85,
            angle_a=feat_angle, angle_b=m.kf_angle[k])
        n_match = jnp.sum(okm)
        Xw = m.mp_pos[jnp.clip(mp_k[idx], 0, m.P - 1)]
        res = _pnp.pnp_ransac(key, Xw, xn, okm.astype(jnp.float32), focal,
                              min_inliers=12)
        return jnp.concatenate([
            jnp.stack([n_match.astype(jnp.float32),
                       res.ok.astype(jnp.float32),
                       res.n_inliers.astype(jnp.float32)]),
            res.R_cw.reshape(9), res.t_cw])

    return jax.vmap(one)(cand_slots, keys)


# ---------------------------------------------------------------------------
# Fully-fused per-frame pipelines: extract + undistort + track + in-graph
# fallback + trajectory row, ONE device dispatch per frame. The host never
# blocks on these results in the hot loop — decisions that need scalars
# (LOST, keyframe insertion) are taken one frame later from an async-copied
# summary (SlamSystem._harvest_pending). This replaces the reference's 20
# fps-paced tracking thread (src/System.cpp:191-192): the hot loop issues
# exactly one dispatch and waits on no device result per frame.
# ---------------------------------------------------------------------------

def _traj_row(m: MapState, P, R, anchor_slot):
    """Pose of this frame relative to its anchor keyframe (the reference's
    mlRelativeFramePoses, src/Tracking.cpp:1123; composed against the FINAL
    keyframe pose at save time so corrections propagate)."""
    Pk = m.kf_ns.P[anchor_slot]
    Rk = m.kf_ns.R[anchor_slot]
    RkT = jnp.swapaxes(Rk, -1, -2)
    P_rel = (RkT @ (P - Pk)[..., None])[..., 0]
    R_rel = RkT @ R
    return P_rel, R_rel, P, R


def _vi_frame_body(m: MapState, img, rawp, cam, ext, noise, ns_last, gw,
                   prior_last, pfm, pan, anchor_slot, dt_f, fresh_prior_fb,
                   sigma_bg, sigma_ba, n_features, n_levels, iters, rtol,
                   fb_min_inliers):
    """One VI frame: ORB extraction, undistortion, fused IMU tracking step,
    and the wide-window visual fallback as a lax.cond branch (the host-side
    retry in the old _track_frame_vi cost a full round trip exactly on the
    frames that were already struggling). pfm/pan None = no previous frame.
    Returns (feats, uv, ns_f, fmp_f, Hp_f, fv, traj, summary_row)."""
    from mc_slam.frontend import extractor as _ex
    feats = _ex.extract(img, n_features=n_features, n_levels=n_levels)
    from mc_slam.camera import undistort_points as _undist
    uv = _undist(cam, feats.xy)
    from mc_slam.imu.preintegration import predict_navstate, preintegrate
    pre_last_cur = preintegrate(rawp, ns_last.bg_full, ns_last.ba_full, noise)
    ns_cur0 = predict_navstate(ns_last, pre_last_cur, gw)
    ns2, feat_mp, n_m, n_in, H_marg = track_frame_vi(
        m, feats, uv, cam, ext, ns_cur0, ns_last, pre_last_cur, gw,
        prior_last, iters=iters, sigma_bg=sigma_bg, sigma_ba=sigma_ba,
        rtol=rtol, prev_feat_mp=pfm, prev_angle=pan)
    bias_jump = ((jnp.max(jnp.abs(ns2.dbg - ns_last.dbg)) > 0.05)
                 | (jnp.max(jnp.abs(ns2.dba - ns_last.dba)) > 0.5))
    H_prior = (0.5 * (H_marg + H_marg.T)
               + 1e-3 * jnp.eye(15, dtype=H_marg.dtype))
    need_fb = (n_in < fb_min_inliers) | bias_jump

    def with_fallback(_):
        resv = track_frame_visual(m, feats, uv, cam, ext, ns_last.P,
                                  ns_last.R, radius_coarse=40.0, iters=iters,
                                  prev_feat_mp=pfm, prev_angle=pan)
        take = (resv.n_inliers > n_in) | bias_jump
        V_est = (resv.P - ns_last.P) / jnp.maximum(dt_f, 1e-3)
        ns_fb = ns_last._replace(P=resv.P, R=resv.R, V=V_est)
        sel = lambda a, b: jnp.where(take, a, b)
        ns_o = jax.tree_util.tree_map(sel, ns_fb, ns2)
        return (ns_o, sel(resv.feat_mp, feat_mp),
                sel(fresh_prior_fb, H_prior),
                sel(resv.n_inliers, n_in), take)

    def no_fallback(_):
        return (ns2, feat_mp, H_prior, n_in,
                jnp.asarray(False))

    ns_f, fmp_f, Hp_f, nin_f, used_fb = jax.lax.cond(
        need_fb, with_fallback, no_fallback, None)
    vis = jnp.zeros(m.P, bool).at[
        jnp.clip(fmp_f, 0, m.P - 1)].set(fmp_f >= 0, mode="drop")
    fv = vis.astype(m.mp_found.dtype)
    traj = _traj_row(m, ns_f.P, ns_f.R, anchor_slot)
    summary = jnp.stack([nin_f.astype(jnp.float32),
                         bias_jump.astype(jnp.float32),
                         used_fb.astype(jnp.float32),
                         n_m.astype(jnp.float32)])
    return feats, uv, ns_f, fmp_f, Hp_f, fv, traj, summary


@partial(jax.jit,
         static_argnames=("n_features", "n_levels", "iters", "rtol",
                          "has_prev"))
def frame_pipeline_vi(m: MapState, img, rawp, cam: Camera,
                      ext: factors.Extrinsics, noise, ns_last, gw,
                      prior_last: ba_vi.PriorFactor, prev_feat_mp, prev_angle,
                      anchor_slot, dt_f, fresh_prior_fb,
                      sigma_bg=2e-5, sigma_ba=5e-3,
                      n_features=1024, n_levels=8, iters: int = 20,
                      rtol: float = 0.0, has_prev: bool = True,
                      fb_min_inliers=20):
    """One dispatch per VI frame (see _vi_frame_body).

    fresh_prior_fb: (15,15) prior info used when the fallback is taken (weak
    pose/velocity, keyframe-grade biases — see SlamSystem._fresh_prior_info).
    Returns (feats, uv, ns2, feat_mp, H_prior, mp_found, mp_vis,
    traj(P_rel, R_rel, P_abs, R_abs), summary[n_in, bias_jump, used_fb,
    n_matches])."""
    pfm = prev_feat_mp if has_prev else None
    pan = prev_angle if has_prev else None
    feats, uv, ns_f, fmp_f, Hp_f, fv, traj, summary = _vi_frame_body(
        m, img, rawp, cam, ext, noise, ns_last, gw, prior_last, pfm, pan,
        anchor_slot, dt_f, fresh_prior_fb, sigma_bg, sigma_ba,
        n_features, n_levels, iters, rtol, fb_min_inliers)
    return (feats, uv, ns_f, fmp_f, Hp_f, m.mp_found + fv, m.mp_visible + fv,
            traj, summary)


@partial(jax.jit,
         static_argnames=("n_features", "n_levels", "iters", "rtol",
                          "has_prev"))
def frame_pipeline_vi_pair(m: MapState, imgs, rawps, cam: Camera,
                           ext: factors.Extrinsics, noise,
                           ns_last, gw, prior_last: ba_vi.PriorFactor,
                           prev_feat_mp, prev_angle, anchor_slot, dts,
                           fresh_prior_fb, sigma_bg=2e-5, sigma_ba=5e-3,
                           n_features=1024, n_levels=8, iters: int = 20,
                           rtol: float = 0.0, has_prev: bool = True,
                           fb_min_inliers=20):
    """N consecutive VI frames fused into ONE dispatch, each chained in-graph
    on the previous frame's state (pose, marginal prior, previous-frame
    match table, angles): N-frame fusion divides the dispatch->result round
    trips per frame by N. The reference has no analog (its per-frame cost is
    CPU compute).

    imgs: TUPLE of N images (separate host uploads overlap in flight);
    rawps: (N, T, 7) raw IMU spans; dts: (N,) frame periods.
    Outputs are per-frame TUPLES (separate device buffers — a stacked
    output would cost slice dispatches at harvest) except the summary,
    which is one (N, 4) buffer so the host pays a single async copy per
    dispatch. Returns (frames, H_prior_last, mp_found, mp_vis, summary)
    where frames = tuple of (feats, uv, fmp, ns, traj) per frame."""
    pfm = prev_feat_mp if has_prev else None
    pan = prev_angle if has_prev else None
    ns = ns_last
    prior = prior_last
    fv_tot = None
    outs = []
    sums = []
    for i in range(len(imgs)):
        feats, uv, ns, fmp, Hp, fv, traj, s = _vi_frame_body(
            m, imgs[i], rawps[i], cam, ext, noise, ns, gw, prior, pfm, pan,
            anchor_slot, dts[i], fresh_prior_fb, sigma_bg, sigma_ba,
            n_features, n_levels, iters, rtol, fb_min_inliers)
        prior = ba_vi.PriorFactor(cam=jnp.asarray(0, jnp.int32), ns0=ns,
                                  info=Hp,
                                  valid=jnp.asarray(1.0, jnp.float32))
        pfm, pan = fmp, feats.angle
        fv_tot = fv if fv_tot is None else fv_tot + fv
        outs.append((feats, uv, fmp, ns, traj))
        sums.append(s)
    return (tuple(outs), prior.info, m.mp_found + fv_tot,
            m.mp_visible + fv_tot, jnp.stack(sums))


@partial(jax.jit,
         static_argnames=("n_features", "n_levels", "iters", "rtol",
                          "has_prev"))
def frame_pipeline_visual(m: MapState, img, cam: Camera,
                          ext: factors.Extrinsics, P_last, R_last, dP, dR,
                          prev_feat_mp, prev_angle, anchor_slot,
                          min_inliers,
                          n_features=1024, n_levels=8, iters: int = 20,
                          rtol: float = 0.0, has_prev: bool = True):
    """One dispatch per visual frame (pre-VI-init / vision-only modes):
    extraction, undistortion, velocity-model tracking, and the wide-window
    retry from the last pose as a lax.cond branch (TrackWithMotionModel's
    widened re-search, src/Tracking.cpp:1735). The motion-prior-free
    reference-keyframe fallback stays on the host (rare; needs PnP RANSAC).

    Returns (feats, uv, res(TrackResult), vel(dP,dR), mp_found, mp_vis,
    traj, summary[n_in, used_fb, n_matches])."""
    from mc_slam.frontend import extractor as _ex
    feats = _ex.extract(img, n_features=n_features, n_levels=n_levels)
    from mc_slam.camera import undistort_points as _undist
    uv = _undist(cam, feats.xy)
    pfm = prev_feat_mp if has_prev else None
    pan = prev_angle if has_prev else None
    res, vel, mp_found, mp_vis = track_frame_visual_step(
        m, feats, uv, cam, ext, P_last, R_last, dP, dR, iters=iters,
        rtol=rtol, prev_feat_mp=pfm, prev_angle=pan)
    need_fb = res.n_inliers < min_inliers

    def with_fallback(_):
        r2 = track_frame_visual(m, feats, uv, cam, ext, P_last, R_last,
                                radius_coarse=40.0, iters=iters)
        take = r2.n_inliers > res.n_inliers
        sel = lambda a, b: jnp.where(take, a, b)
        r_o = TrackResult(P=sel(r2.P, res.P), R=sel(r2.R, res.R),
                          feat_mp=sel(r2.feat_mp, res.feat_mp),
                          n_matches=sel(r2.n_matches, res.n_matches),
                          n_inliers=sel(r2.n_inliers, res.n_inliers))
        RlT = jnp.swapaxes(R_last, -1, -2)
        vel_o = ((RlT @ (r_o.P - P_last)[..., None])[..., 0], RlT @ r_o.R)
        return r_o, vel_o, take

    def no_fallback(_):
        return res, vel, jnp.asarray(False)

    res_f, vel_f, used_fb = jax.lax.cond(need_fb, with_fallback,
                                         no_fallback, None)
    vis = jnp.zeros(m.P, bool).at[
        jnp.clip(res_f.feat_mp, 0, m.P - 1)].set(res_f.feat_mp >= 0,
                                                 mode="drop")
    fv = vis.astype(m.mp_found.dtype)
    traj = _traj_row(m, res_f.P, res_f.R, anchor_slot)
    summary = jnp.stack([res_f.n_inliers.astype(jnp.float32),
                         used_fb.astype(jnp.float32),
                         res_f.n_matches.astype(jnp.float32)])
    return (feats, uv, res_f, vel_f, m.mp_found + fv, m.mp_visible + fv,
            traj, summary)
