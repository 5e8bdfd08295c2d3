"""Synchronous per-frame tracking paths (SlamSystem mixin): visual/VI
tracking, the post-reloc bias window, reference-KF fallback, and
relocalization (Tracking.cpp state machine bodies). Split from system.py
(r4 verdict item 9) - no behavior change.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.camera import undistort_points
from mc_slam.frontend import bow, extractor, matching
from mc_slam.geometry import init2view, pnp
from mc_slam.imu.navstate import NavState, navstate_identity
from mc_slam.imu.preintegration import (preint_identity, preintegrate,
                                            predict_navstate)
from mc_slam.pipeline import loopclosing, mapping, tracking, viinit
from mc_slam.pipeline.pipebase import (NO_IMAGES_YET, NOT_INITIALIZED, OK,
                                           LOST)
from mc_slam.slam_map.mapstate import (MapState, covisibility_weights,
                                            empty_map, observation_counts)
from mc_slam.solver import ba, ba_chunked, ba_vi, ba_vi_idp, factors
from mc_slam.solver.ba import VisualObs


class TrackingCtlMixin:
    # ------------------------------------------------------------------
    # Per-frame tracking
    # ------------------------------------------------------------------
    def _track_frame(self, feats, uv, t):
        if self.vi_inited and self.reloc_buf is not None:
            return self._track_frame_reloc_window(feats, uv, t)
        if self.vi_inited:
            return self._track_frame_vi(feats, uv, t)
        # pre-VI-init, per-frame IMU windows are unused (re-seeded at init time)
        self.imu_since_frame = []
        cfg = self.cfg
        P_last, R_last = self.last_pose
        dP, dR = self.velocity
        pfm, pang = self._prev_match if self._prev_match is not None else (None, None)
        res, vel, mp_found, mp_vis = tracking.track_frame_visual_step(
            self.m, feats, uv, self.cam, self.ext, P_last, R_last, dP, dR,
            feat_ur=self._cur_ur, bf=self._bf, rtol=cfg.track_rtol,
            prev_feat_mp=pfm, prev_angle=pang)
        n_in = int(res.n_inliers)
        if n_in < cfg.min_track_inliers:
            # fallback: retry from last pose with a wide window
            res = tracking.track_frame_visual(self.m, feats, uv, self.cam,
                                              self.ext, P_last, R_last,
                                              radius_coarse=40.0,
                                              feat_ur=self._cur_ur, bf=self._bf)
            n_in = int(res.n_inliers)
            if n_in < cfg.min_track_inliers:
                # motion-prior-free fallback against the reference keyframe
                # (TrackReferenceKeyFrame, src/Tracking.cpp:1524)
                res2 = self._track_reference_kf(feats, uv)
                if res2 is None:
                    self.state = LOST
                    self._prev_match = None
                    return False
                res, n_in = res2, int(res2.n_inliers)
            # velocity model + counters for the fallback result
            RlT = jnp.swapaxes(R_last, -1, -2)
            vel = ((RlT @ (res.P - P_last)[..., None])[..., 0], RlT @ res.R)
            mp_found = mp_vis = None
        self.velocity = vel                  # (src/Tracking.cpp:1123-1134)
        self.last_pose = (res.P, res.R)
        self._cur_feat_mp = res.feat_mp
        self._prev_match = (res.feat_mp, feats.angle)
        self._cur_inliers = n_in
        if mp_found is None:
            vis_mask = jnp.zeros(self.m.P, bool).at[
                jnp.clip(res.feat_mp, 0, self.m.P - 1)].set(
                    res.feat_mp >= 0, mode="drop")
            self.m = mapping.update_found_visible(self.m, vis_mask, vis_mask)
        else:
            self.m = self.m._replace(mp_found=mp_found, mp_visible=mp_vis)
        self.state = OK
        return True

    @staticmethod
    def _imu_rows(buf):
        """Concatenate (frame_id, rows) blocks into one (T,7) array."""
        if not buf:
            return np.zeros((0, 7), np.float32)
        return np.concatenate([r for _, r in buf], 0)

    def _preintegrate_raw(self, raw, bg, ba):
        """Chunked preintegration of an arbitrary-length host IMU buffer:
        chains fixed-size scans through `init`, lifting the fixed-row
        truncation that silently shortened long keyframe gaps (culling can
        legally open gaps up to 3 s, src/KeyFrame.cpp:195-252 ComputePreInt
        over the full spliced span). A truncated preintegration makes the PRV
        residual inconsistent with the state delta and the optimizer dumps the
        mismatch into the biases."""
        L = self.cfg.max_imu_per_kf
        pre = None
        n = len(raw)
        for s in range(0, max(n, 1), L):
            chunk = raw[s:s + L]
            rawp = np.zeros((L, 7), np.float32)
            rawp[:len(chunk)] = chunk
            pre = preintegrate(jnp.asarray(rawp), bg, ba, self.noise, init=pre)
        return pre

    @staticmethod
    def _fresh_prior_info(pose_info):
        """15x15 prior information for a freshly (re)seated frame state,
        order [P, phi, V, dbg, dba].

        Pose/velocity get `pose_info` (weak: the next visual solve should
        dominate), but BIASES get window-BA-level confidence (sigma_bg ~1e-3,
        sigma_ba ~1e-2): the re-seated state's biases come from the keyframe
        chain, which is RW-anchored all the way back to VI init. An isotropic
        weak prior here (the old identity*1e3, sigma_bias ~0.03) let the
        per-frame estimator re-derive biases from ~1 s of data between
        keyframes — noise-dominated, so the frame bias wandered +-0.03,
        every new keyframe injected that wander into the chain (observed as
        a ~5e6 bias-RW edge cost on each newest keyframe), and the window BA
        could only partially smooth it back (the wander is RW-plausible per
        edge), accumulating into 0.05+ accel-bias error and the post-init
        sawtooth. The reference never weakens its bias prior: mMargCovInv
        chains the full marginal frame to frame (src/Optimizer.cpp:1997-2014)
        and map updates re-anchor the frame's bias to the KEYFRAME state
        (PoseOptimization(F, LastKF), src/Tracking.cpp:338-412)."""
        d = np.full(15, float(pose_info), np.float32)
        d[9:12] = 1e6    # gyro bias: sigma ~1e-3 rad/s
        d[12:15] = 1e4   # accel bias: sigma ~1e-2 m/s^2
        return np.diag(d)

    def _track_frame_vi(self, feats, uv, t):
        """IMU-predicted tracking with the marginal prior
        (Tracking::TrackWithIMU + TrackLocalMapWithIMU)."""
        cfg = self.cfg
        rows = self._imu_rows(self.imu_since_frame)
        rows = rows[-cfg.max_imu_per_kf:]
        rawp = np.zeros((cfg.max_imu_per_kf, 7), np.float32)
        rawp[:len(rows)] = rows
        if self.prior is None:
            self.prior = ba_vi.PriorFactor(
                cam=jnp.asarray(0, jnp.int32), ns0=self.last_ns,
                info=jnp.asarray(self._fresh_prior_info(1e3), jnp.float32),
                valid=jnp.asarray(1.0, jnp.float32))
        # fused step: track + bias-jump sanity + prior symmetrization +
        # found/visible counters all on device; ONE small host pull per frame
        ns2, feat_mp, H_prior, mp_found, mp_vis, summary = \
            tracking.track_frame_vi_step(
                self.m, feats, uv, self.cam, self.ext, jnp.asarray(rawp),
                self.noise, self.last_ns, self.gw, self.prior,
                sigma_bg=float(self.noise.sigma_bg),
                sigma_ba=float(self.noise.sigma_ba),
                feat_ur=self._cur_ur, bf=self._bf, rtol=cfg.track_rtol,
                prev_feat_mp=(self._prev_match[0] if self._prev_match is not None else None),
                prev_angle=(self._prev_match[1] if self._prev_match is not None else None))
        summary = np.asarray(summary)
        n_in = int(summary[0])
        # sanity gate on the per-frame bias step: the bias random walk allows
        # ~1e-3 between frames; a jump orders of magnitude beyond that means
        # the joint solve went numerically bad (f32 PRV information can come
        # out indefinite on degenerate windows) — one poisoned NavState kills
        # IMU prediction for every following frame
        bias_jump = bool(summary[1])
        if n_in < 20 or bias_jump:
            # IMU prediction missed the match window (bad gravity/bias or fast
            # motion): fall back to wide-window visual tracking from the last
            # pose, as the reference widens th and drops to
            # TrackReferenceKeyFrame (src/Tracking.cpp:358-365, :876-884)
            resv = tracking.track_frame_visual(
                self.m, feats, uv, self.cam, self.ext,
                self.last_ns.P, self.last_ns.R, radius_coarse=40.0)
            if int(resv.n_inliers) > n_in or bias_jump:
                dt_f = max(t - self.last_time, 1e-3)
                V_est = (resv.P - self.last_ns.P) / dt_f
                ns2 = self.last_ns._replace(P=resv.P, R=resv.R, V=V_est)
                feat_mp = resv.feat_mp
                n_in = int(resv.n_inliers)
                # weak fresh prior on pose/velocity; biases keep their anchor
                H_prior = jnp.asarray(self._fresh_prior_info(1e2), jnp.float32)
                mp_found = mp_vis = None       # recompute for the new feat_mp
        # accept threshold: >= 6 inliers with IMU support (src/Tracking.cpp:281-288)
        if n_in < max(6, cfg.min_track_inliers // 2):
            self.state = LOST
            self._prev_match = None
            return False
        self.last_ns = ns2
        self.last_pose = (ns2.P, ns2.R)
        # next frame's prior: this frame's marginal information (+ floor)
        self.prior = ba_vi.PriorFactor(
            cam=self._c0i, ns0=ns2, info=H_prior, valid=self._c1f)
        self.imu_since_frame = []
        self._cur_feat_mp = feat_mp
        self._prev_match = (feat_mp, feats.angle)
        self._cur_inliers = n_in
        if mp_found is None:
            vis_mask = jnp.zeros(self.m.P, bool).at[
                jnp.clip(feat_mp, 0, self.m.P - 1)].set(feat_mp >= 0, mode="drop")
            self.m = mapping.update_found_visible(self.m, vis_mask, vis_mask)
        else:
            self.m = self.m._replace(mp_found=mp_found, mp_visible=mp_vis)
        self.state = OK
        return True

    def _track_frame_reloc_window(self, feats, uv, t):
        """Visual tracking while the post-reloc bias window fills (the
        reference tracks without IMU while mbRelocBiasPrepare is set)."""
        cfg = self.cfg
        rows = self._imu_rows(self.imu_since_frame)
        self.imu_since_frame = []
        P_last, R_last = self.last_pose
        dP, dR = self.velocity
        P0 = P_last + (R_last @ dP[..., None])[..., 0]
        R0 = R_last @ dR
        res = tracking.track_frame_visual(self.m, feats, uv, self.cam, self.ext,
                                          P0, R0, feat_ur=self._cur_ur,
                                          bf=self._bf)
        n_in = int(res.n_inliers)
        if n_in < cfg.min_track_inliers:
            res = tracking.track_frame_visual(self.m, feats, uv, self.cam,
                                              self.ext, P_last, R_last,
                                              radius_coarse=40.0,
                                              feat_ur=self._cur_ur, bf=self._bf)
            n_in = int(res.n_inliers)
            if n_in < cfg.min_track_inliers:
                self.state = LOST
                self.reloc_buf = None      # window aborted; re-relocalize
                self._prev_match = None
                return False
        RlT = jnp.swapaxes(R_last, -1, -2)
        self.velocity = ((RlT @ (res.P - P_last)[..., None])[..., 0], RlT @ res.R)
        self.last_pose = (res.P, res.R)
        self._cur_feat_mp = res.feat_mp
        self._cur_inliers = n_in
        self.state = OK
        self.reloc_buf.append(dict(
            t=t, P=np.asarray(res.P), R=np.asarray(res.R),
            feat_mp=np.asarray(res.feat_mp),
            uv=np.asarray(uv), level=np.asarray(feats.level),
            valid=np.asarray(feats.valid), imu=rows))
        if len(self.reloc_buf) >= self.reloc_window:
            self._recompute_bias_from_window()
            self.reloc_buf = None
            self._invalidate_frame_caches()
        return True

    def _recompute_bias_from_window(self):
        """Re-solve biases + NavState over the buffered post-reloc frames
        (Tracking::RecomputeIMUBiasAndCurrentNavstate, src/Tracking.cpp:47-220)
        as multi-frame fixed-point VI optimization: every frame pose is free,
        chained by IMU PRV + bias-RW edges against the (fixed) map."""
        buf = self.reloc_buf
        N = len(buf)
        cfg = self.cfg
        L = cfg.max_imu_per_kf
        bg0 = self.last_ns.bg_full
        ba0 = self.last_ns.ba_full
        # preintegrate each inter-frame IMU batch at the stale bias
        raw = np.zeros((N - 1, L, 7), np.float32)
        for i in range(1, N):
            r = buf[i]["imu"][-L:]
            raw[i - 1, :len(r)] = r
        pre = jax.vmap(lambda rr: preintegrate(rr, bg0, ba0, self.noise))(
            jnp.asarray(raw))
        # initial NavStates from the visual poses; V by forward differences
        P = np.stack([b["P"] for b in buf])
        R = np.stack([b["R"] for b in buf])
        ts = np.asarray([b["t"] for b in buf])
        V = np.zeros_like(P)
        V[:-1] = (P[1:] - P[:-1]) / np.maximum(
            (ts[1:] - ts[:-1])[:, None], 1e-3)
        V[-1] = V[-2]
        z3 = np.zeros((N, 3), np.float32)
        ns0 = NavState(P=jnp.asarray(P), R=jnp.asarray(R), V=jnp.asarray(V),
                       bg=jnp.broadcast_to(bg0, (N, 3)),
                       ba=jnp.broadcast_to(ba0, (N, 3)),
                       dbg=jnp.asarray(z3), dba=jnp.asarray(z3))
        edges = ba_vi.IMUEdges(
            i=jnp.arange(0, N - 1, dtype=jnp.int32),
            j=jnp.arange(1, N, dtype=jnp.int32),
            pre=pre, info_prv=factors.imu_prv_info(pre),
            info_bias=factors.bias_rw_info(pre.dT, float(self.noise.sigma_bg),
                                           float(self.noise.sigma_ba)),
            valid=jnp.ones(N - 1, jnp.float32))
        Fn = self.m.F
        mp = np.stack([b["feat_mp"] for b in buf]).reshape(-1)
        lvl = np.stack([b["level"] for b in buf]).reshape(-1)
        fv = np.stack([b["valid"] for b in buf]).reshape(-1)
        obs = VisualObs(
            cam=jnp.repeat(jnp.arange(N, dtype=jnp.int32), Fn),
            pt=jnp.asarray(np.clip(mp, 0, self.m.P - 1), jnp.int32),
            uv=jnp.asarray(np.stack([b["uv"] for b in buf]).reshape(-1, 2),
                           jnp.float32),
            inv_sigma2=jnp.asarray(
                1.0 / (1.2 ** (2.0 * lvl.astype(np.float32))), jnp.float32),
            valid=jnp.asarray(((mp >= 0) & fv).astype(np.float32)))
        free = jnp.ones(N, jnp.float32)
        # single phase: the reference's bias recompute is one closed-form
        # solve over the whole window with no outlier rounds
        # (src/Tracking.cpp:47-220); an early re-classification on 4-iteration
        # residuals prunes informative observations and degrades the recovery
        ns2, _, chi2, cost = ba_vi.vi_ba(
            ns0, self.m.mp_pos, obs, edges, self.cam, self.ext, self.gw,
            free, self.m.mp_active.astype(jnp.float32), prior=None,
            iters=10, fix_points=True, two_phase=False)
        nsl = jax.tree_util.tree_map(lambda a: a[-1], ns2)
        if bool(jnp.all(jnp.isfinite(nsl.P)) & jnp.all(jnp.isfinite(nsl.V))):
            self.last_ns = nsl
            self.last_pose = (nsl.P, nsl.R)
            self.prior = None

    def _invalidate_frame_caches(self):
        """Drop per-frame caches after any KF-rate map mutation (new KF, BA,
        culling, loop correction, VI init, relocalization)."""
        self._ref_tracked_cache = None
        self._anchor_cache = None
        self._covis_row_cache = None
        self._map_epoch = getattr(self, "_map_epoch", 0) + 1

    def _need_new_kf(self, fid=None):
        cfg = self.cfg
        fid = self.frame_id if fid is None else fid
        if self.reloc_buf is not None:
            return False
        since = fid - self.last_kf_frame
        if since < cfg.kf_min_gap:
            return False
        if since >= cfg.kf_max_gap:
            return True
        # ratio of current inliers vs reference-KF WELL-OBSERVED points
        # (TrackedMapPoints(nMinObs=3), src/Tracking.cpp:1893 — counting every
        # association makes the ratio rule fire per-frame and flood the map).
        # The count only changes at KF-rate map mutations — cached between
        # keyframes (tracking never edits keyframe observation rows)
        if getattr(self, "_ref_tracked_cache", None) is None:
            mp_ref = self.m.kf_mp[self.last_kf_slot]
            obs_n = observation_counts(self.m)
            min_obs = 2 if len(self.kf_slots) <= 2 else 3
            well = ((mp_ref >= 0)
                    & (obs_n[jnp.clip(mp_ref, 0, self.m.P - 1)] >= min_obs))
            self._ref_tracked_cache = int(jnp.sum(well))
        ref_tracked = self._ref_tracked_cache
        return (self._cur_inliers < cfg.kf_ref_ratio * max(ref_tracked, 1)
                and self._cur_inliers > 15)

    def _create_keyframe(self, feats, uv, t, fid=None, pose=None, ns=None,
                         feat_mp=None):
        P, R = pose if pose is not None else self.last_pose
        # carry THIS FRAME's tracked associations into the KF (with in-flight
        # frames, self._cur_feat_mp belongs to the newest dispatch, whose
        # feature table is a different frame's); written inside the fused
        # insert program
        fm = feat_mp if feat_mp is not None else self._cur_feat_mp
        return self._insert_kf_raw(P, R, feats, uv, t_kf=t, fid=fid, ns=ns,
                                   feat_mp=fm)


    def _track_reference_kf(self, feats, uv):
        """TrackReferenceKeyFrame (src/Tracking.cpp:1524): when both motion-
        model searches fail, match the frame's descriptors against the
        reference keyframe's landmark features (no motion prior), solve PnP,
        and refine against the map. Returns a TrackResult or None."""
        from mc_slam.frontend import matching as matching_mod
        k = self.last_kf_slot
        if k is None or k not in self.kf_slots:
            return None
        mp_k = self.m.kf_mp[k]
        has = (mp_k >= 0) & self.m.kf_feat_valid[k]
        idx, best, okm = matching_mod.mutual_match(
            feats.desc_pm1, feats.valid, self.m.kf_pm1[k], has,
            max_dist=matching_mod.TH_LOW, ratio=0.85,
            angle_a=feats.angle, angle_b=self.m.kf_angle[k])
        if int(jnp.sum(okm)) < 15:
            return None
        xn = (np.asarray(uv) - [float(self.cam.cx), float(self.cam.cy)]) / \
            [float(self.cam.fx), float(self.cam.fy)]
        Xw = self.m.mp_pos[jnp.clip(mp_k[idx], 0, self.m.P - 1)]
        self.key, sub = jax.random.split(self.key)
        res = pnp.pnp_ransac(sub, Xw, jnp.asarray(xn, jnp.float32),
                             okm.astype(jnp.float32), float(self.cam.fx),
                             min_inliers=12)
        if not bool(res.ok):
            return None
        R_wc = res.R_cw.T
        C = -(R_wc @ res.t_cw[..., None])[..., 0]
        P_b, R_b = self._cam_to_body(C, R_wc)
        tr = tracking.track_frame_visual(self.m, feats, uv, self.cam, self.ext,
                                         P_b, R_b, radius_coarse=15.0,
                                         feat_ur=self._cur_ur, bf=self._bf)
        if int(tr.n_inliers) < self.cfg.min_track_inliers:
            return None
        return tr

    # ------------------------------------------------------------------
    # Relocalization (Tracking::Relocalization, src/Tracking.cpp:2388):
    # BoW candidates -> 2D-3D descriptor matching -> PnP RANSAC -> refine
    # ------------------------------------------------------------------
    def _relocalize(self, feats, uv, t):
        cfg = self.cfg
        act = list(self.kf_slots)
        if not act:
            return False
        q = bow.bow_histogram(feats.desc_pm1,
                              feats.valid.astype(jnp.float32),
                              self.loop.vocab, idf=self.loop.idf)
        scores = np.asarray(self.loop.hists @ q)[act]
        focal = float(self.cam.fx)
        xn = (np.asarray(uv) - [float(self.cam.cx), float(self.cam.cy)]) / \
            [float(self.cam.fx), float(self.cam.fy)]
        # candidate set as the reference: everything scoring >= 0.75x the best
        # accumulated score (KeyFrameDatabase::DetectRelocalizationCandidates),
        # capped — reloc runs at frame rate while lost, so the cap bounds the
        # per-frame host work
        order = np.argsort(-scores)
        best_s = scores[order[0]] if len(order) else 0.0
        cand = [act[int(oi)] for oi in order[:5]
                if scores[int(oi)] >= 0.75 * best_s]
        if not cand:
            return False
        # ALL candidates' descriptor match + PnP in ONE device program with
        # ONE pull (tracking.reloc_candidates_batch): the per-candidate host
        # loop cost ~6 round trips each and reloc runs every frame while lost
        C_PAD = 5
        cand_p = (cand + [cand[0]] * C_PAD)[:C_PAD]
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, C_PAD)
        packed = np.asarray(tracking.reloc_candidates_batch(
            self.m, jnp.asarray(cand_p, jnp.int32), keys, feats.desc_pm1,
            feats.valid, feats.angle, jnp.asarray(xn, jnp.float32),
            focal))
        for i in range(len(cand)):
            k = cand_p[i]
            n_match, pnp_ok = packed[i, 0], packed[i, 1]
            if n_match < 15 or pnp_ok < 0.5:
                continue
            R_cw = packed[i, 3:12].reshape(3, 3)
            t_cw = packed[i, 12:15]
            # camera pose -> body pose, then refine against the map
            R_wc = R_cw.T
            C = -(R_wc @ t_cw)
            P_b, R_b = self._cam_to_body(jnp.asarray(C, jnp.float32),
                                         jnp.asarray(R_wc, jnp.float32))
            tr = tracking.track_frame_visual(self.m, feats, uv, self.cam,
                                             self.ext, P_b, R_b,
                                             radius_coarse=15.0)
            if 0 < cfg.min_track_inliers - int(tr.n_inliers) <= 4:
                # near miss: escalate with a wider guided re-search from the
                # refined pose, as the reference's second SearchByProjection
                # pass when 10 < inliers < 50 (src/Tracking.cpp:2388-2566)
                tr2 = tracking.track_frame_visual(
                    self.m, feats, uv, self.cam, self.ext, tr.P, tr.R,
                    radius_coarse=30.0)
                if int(tr2.n_inliers) > int(tr.n_inliers):
                    tr = tr2
            if int(tr.n_inliers) >= cfg.min_track_inliers:
                self.last_pose = (tr.P, tr.R)
                self.velocity = (jnp.zeros(3), jnp.eye(3))
                self._cur_feat_mp = tr.feat_mp
                self._cur_inliers = int(tr.n_inliers)
                if self.vi_inited:
                    # re-seat the NavState and open the 20-frame bias window
                    # (Relocalization sets mbRelocBiasPrepare,
                    # src/Tracking.cpp:2388; biases re-solved after 20 frames
                    # by RecomputeIMUBiasAndCurrentNavstate :47-220)
                    self.last_ns = self.last_ns._replace(
                        P=tr.P, R=tr.R, V=jnp.zeros(3))
                    self.prior = None
                    self.reloc_buf = []
                    self.imu_since_frame = []
                    self.imu_since_kf = []
                    self._chain_break_pending = True
                self.state = OK
                self.events.append((self.frame_id, "reloc",
                                    dict(kf=k, n_in=int(tr.n_inliers))))
                return True
        return False

