"""Asynchronous frame-loop orchestration (SlamSystem mixin).

The fused per-frame dispatch / deferred-harvest machinery: the single-loop
replacement for the reference's tracking thread running ahead of
LocalMapping/LoopClosing (src/System.cpp:191-203). Split from system.py
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


class FrameLoopMixin:
    # ------------------------------------------------------------------
    # Fused async per-frame path
    # ------------------------------------------------------------------
    def _anchor_slot(self):
        k = self.last_kf_slot
        if k is not None and k in self.kf_slots:
            return k, self.kf_id_host[k]
        return -1, -1

    def _record_traj_sync(self, t):
        """Trajectory row for a synchronously-tracked frame (one small
        dispatch; these paths are off the hot loop)."""
        k, kid = self._anchor_slot()
        P, R = self.last_pose
        row = self._traj_row_jit(self.m, P, R,
                                 jnp.asarray(max(k, 0), jnp.int32))
        if k < 0:
            row = (jnp.zeros(3), jnp.eye(3), row[2], row[3])
        self.traj.append(row, t, k, kid)

    @property
    def _traj_row_jit(self):
        fn = getattr(self, "_traj_row_jit_", None)
        if fn is None:
            fn = jax.jit(tracking._traj_row)
            self._traj_row_jit_ = fn
        return fn

    def _capture_imu_frame(self):
        """Consume the per-frame IMU buffer into a fixed-size raw array."""
        cfg = self.cfg
        rows = self._imu_rows(self.imu_since_frame)
        rows = rows[-cfg.max_imu_per_kf:]
        rawp = np.zeros((cfg.max_imu_per_kf, 7), np.float32)
        rawp[:len(rows)] = rows
        self.imu_since_frame = []
        return rawp

    def _state_backup(self):
        return (self.last_ns, self.prior, self.last_pose, self.velocity,
                self._prev_match, self.m.mp_found, self.m.mp_visible,
                self._cur_feat_mp)

    def _pair_push(self, img, t):
        """N-frame fusion (PAIR=N): buffer VI frames; dispatch all N as ONE
        fused device program on the Nth (frame_pipeline_vi_pair): N-frame
        fusion divides the dispatch->result round trips per frame by N."""
        rawp = self._capture_imu_frame()
        dt_f = np.float32(max(t - self.last_time, 1e-3))
        if self._pair_buf is None:
            self._pair_buf = []
        self._pair_buf.append(dict(img=img, t=t, rawp=rawp, dt=dt_f,
                                   fid=self.frame_id,
                                   backup=(self._state_backup()
                                           if not self._pair_buf else None)))
        if len(self._pair_buf) >= self.PAIR:
            bufs = self._pair_buf
            self._pair_buf = None
            self._dispatch_frame_vi_pair(bufs)

    def _flush_pair_buf(self):
        """Dispatch buffered sub-batch frames singly (drain path)."""
        bufs = getattr(self, "_pair_buf", None)
        if not bufs:
            self._pair_buf = None
            return
        self._pair_buf = None
        for buf in bufs:
            self._dispatch_frame_vi(buf["img"], buf["t"], rawp=buf["rawp"],
                                    dt_f=buf["dt"], fid=buf["fid"])

    def _dispatch_frame_vi_pair(self, bufs):
        cfg = self.cfg
        if self.prior is None:
            self.prior = ba_vi.PriorFactor(
                cam=self._c0i, ns0=self.last_ns,
                info=self._prior_fresh_1e3, valid=self._c1f)
        pfm, pan = (self._prev_match if self._prev_match is not None
                    else (self._zero_fmp, self._zero_ang))
        k, kid = self._anchor_slot()
        imgs = tuple(b["img"] for b in bufs)
        rawps = np.stack([b["rawp"] for b in bufs])
        dts = np.asarray([b["dt"] for b in bufs], np.float32)
        (frames, Hp_last, mp_found, mp_vis,
         summary) = tracking.frame_pipeline_vi_pair(
            self.m, imgs, rawps, self.cam,
            self.ext, self.noise, self.last_ns, self.gw, self.prior, pfm,
            pan, np.int32(max(k, 0)), dts, self._fresh_fb,
            sigma_bg=float(self.noise.sigma_bg),
            sigma_ba=float(self.noise.sigma_ba),
            n_features=cfg.n_feat, n_levels=cfg.n_levels,
            rtol=cfg.track_rtol, has_prev=self._prev_match is not None)
        try:
            summary.copy_to_host_async()
        except Exception:
            pass
        feats_z, uv_z, fmp_z, ns_z, _ = frames[-1]
        self.last_ns = ns_z
        self.last_pose = (ns_z.P, ns_z.R)
        self.prior = ba_vi.PriorFactor(cam=self._c0i, ns0=ns_z, info=Hp_last,
                                       valid=self._c1f)
        self._cur_feat_mp = fmp_z
        self._prev_match = (fmp_z, feats_z.angle)
        self.m = self.m._replace(mp_found=mp_found, mp_visible=mp_vis)
        self.last_feats = feats_z
        row_0 = len(self.traj.meta)
        for b, (feats, uv, fmp, ns, traj) in zip(bufs, frames):
            self.traj.append(traj, b["t"], k, kid)
        self._pendings.append(dict(
            mode="vi2", row=row_0, summary=summary,
            backup=bufs[0]["backup"], epoch=self._map_epoch,
            frames=tuple(
                dict(feats=feats, uv=uv, t=b["t"], frame_id=b["fid"],
                     feat_mp=fmp, pose=(ns.P, ns.R), ns=ns)
                for b, (feats, uv, fmp, ns, _) in zip(bufs, frames))))

    def _dispatch_frame_vi(self, img, t, rawp=None, dt_f=None, fid=None,
                           backup=None):
        """Dispatch the fused VI frame program; no host sync."""
        cfg = self.cfg
        if rawp is None:
            rawp = self._capture_imu_frame()
        if self.prior is None:
            self.prior = ba_vi.PriorFactor(
                cam=self._c0i, ns0=self.last_ns,
                info=self._prior_fresh_1e3, valid=self._c1f)
        pfm, pan = (self._prev_match if self._prev_match is not None
                    else (self._zero_fmp, self._zero_ang))
        k, kid = self._anchor_slot()
        if dt_f is None:
            dt_f = np.float32(max(t - self.last_time, 1e-3))
        if backup is None:
            backup = self._state_backup()
        (feats, uv, ns2, feat_mp, H_prior, mp_found, mp_vis, traj_row,
         summary) = tracking.frame_pipeline_vi(
            self.m, img, rawp, self.cam, self.ext, self.noise, self.last_ns,
            self.gw, self.prior, pfm, pan,
            np.int32(max(k, 0)), dt_f, self._fresh_fb,
            sigma_bg=float(self.noise.sigma_bg),
            sigma_ba=float(self.noise.sigma_ba),
            n_features=cfg.n_feat, n_levels=cfg.n_levels,
            rtol=cfg.track_rtol, has_prev=self._prev_match is not None)
        try:
            summary.copy_to_host_async()
        except Exception:
            pass
        # optimistic state update (rolled back at harvest if the frame was
        # actually lost)
        self.last_ns = ns2
        self.last_pose = (ns2.P, ns2.R)
        self.prior = ba_vi.PriorFactor(cam=self._c0i, ns0=ns2, info=H_prior,
                                       valid=self._c1f)
        self._cur_feat_mp = feat_mp
        self._prev_match = (feat_mp, feats.angle)
        self.m = self.m._replace(mp_found=mp_found, mp_visible=mp_vis)
        self.last_feats = feats
        self.traj.append(traj_row, t, k, kid)
        self._pendings.append(dict(
            mode="vi", row=len(self.traj.meta) - 1, summary=summary, feats=feats, uv=uv,
                             t=t,
                             frame_id=self.frame_id if fid is None else fid,
                             backup=backup,
                             epoch=self._map_epoch, feat_mp=feat_mp,
                             pose=(ns2.P, ns2.R), ns=ns2))

    def _dispatch_frame_visual(self, img, t):
        """Dispatch the fused visual frame program; no host sync."""
        cfg = self.cfg
        self.imu_since_frame = []     # pre-init per-frame IMU is unused
        P_last, R_last = self.last_pose
        dP, dR = self.velocity
        pfm, pan = (self._prev_match if self._prev_match is not None
                    else (self._zero_fmp, self._zero_ang))
        k, kid = self._anchor_slot()
        backup = (self.last_ns, self.prior, self.last_pose, self.velocity,
                  self._prev_match, self.m.mp_found, self.m.mp_visible,
                  self._cur_feat_mp)
        (feats, uv, res, vel, mp_found, mp_vis, traj_row,
         summary) = tracking.frame_pipeline_visual(
            self.m, img, self.cam, self.ext, P_last, R_last, dP, dR,
            pfm, pan, np.int32(max(k, 0)),
            np.int32(cfg.min_track_inliers),
            n_features=cfg.n_feat, n_levels=cfg.n_levels,
            rtol=cfg.track_rtol, has_prev=self._prev_match is not None)
        try:
            summary.copy_to_host_async()
        except Exception:
            pass
        self.velocity = vel
        self.last_pose = (res.P, res.R)
        self._cur_feat_mp = res.feat_mp
        self._prev_match = (res.feat_mp, feats.angle)
        self.m = self.m._replace(mp_found=mp_found, mp_visible=mp_vis)
        self.last_feats = feats
        self.traj.append(traj_row, t, k, kid)
        self._pendings.append(dict(
            mode="vis", row=len(self.traj.meta) - 1, summary=summary, feats=feats, uv=uv,
                             t=t, frame_id=self.frame_id, backup=backup,
                             epoch=self._map_epoch, feat_mp=res.feat_mp,
                             pose=(res.P, res.R),
                             pose_before=(P_last, R_last)))

    def _rollback_pending(self, p):
        # drop this frame's trajectory row and every newer in-flight frame's
        # (they were dispatched from the lost state)
        self.traj.truncate(p["row"])
        self.n_lost_frames += sum(2 if q["mode"] == "vi2" else 1
                                  for q in self._pendings)
        self._pendings.clear()
        if self._pair_buf:
            self.n_lost_frames += len(self._pair_buf)
        self._pair_buf = None
        if p.get("epoch") != self._map_epoch:
            # a keyframe event / closure / VI init re-seated the tracking
            # state after this frame was dispatched: the dispatch-time backup
            # is stale — keep the newer (post-event) state and only drop the
            # frame (relocalization re-seats the pose anyway)
            return
        (self.last_ns, self.prior, self.last_pose, self.velocity,
         self._prev_match, mp_found, mp_vis, self._cur_feat_mp) = p["backup"]
        self.m = self.m._replace(mp_found=mp_found, mp_visible=mp_vis)

    def _summary_ready(self, p):
        try:
            return bool(p["summary"].is_ready())
        except Exception:
            # backend without is_ready: fall back to the fixed-depth rule
            return True

    def _harvest_pending(self, drain=False):
        """Apply the deferred decisions for due in-flight frames: LOST
        transition, keyframe insertion (+ local mapping, loop closing), and
        the VI-init attempt. A frame is due once its async summary copy has
        landed (and at least LAG_MIN newer frames are in flight), or
        unconditionally at depth LAG_MAX — the hot loop blocks only when the
        pipeline is genuinely full. drain=True consumes everything (mode
        transitions, flush)."""
        if drain:
            self._flush_pair_buf()
        self._harvest_event(force=drain)
        self._harvest_sim3(force=drain)
        self._harvest_verify(force=drain)
        # deep pipelining only once VI-initialized: during the visual
        # bootstrap the map is small and keyframes come every few frames —
        # deferring insertion/LOST decisions by LAG_MAX frames there starves
        # tracking of new triangulations and causes relocalization storms
        # (measured on the euroc clone: 8 relocs in the first 200 frames at
        # depth 8 vs 0 at depth 2). Post-init, IMU-predicted tracking
        # tolerates the deeper queue and the depth hides the device round
        # trip.
        lag_max = self.LAG_MAX if self.vi_inited else 2
        while self._pendings and (
                drain or len(self._pendings) >= lag_max
                or (len(self._pendings) >= self.LAG_MIN
                    and self._summary_ready(self._pendings[0]))):
            self._harvest_one()

    def _harvest_one(self):
        p = self._pendings.popleft()
        cfg = self.cfg
        if p["mode"] == "vi2":
            return self._harvest_pair(p)
        # stall attribution: a pull on a landed copy is ~free; one on a
        # not-yet-ready summary blocks on the whole in-flight device queue
        name = ("harvest_pull" if self._summary_ready(p)
                else "harvest_pull_block")
        with self.timers.stage(name):
            s = np.asarray(p["summary"])
        n_in = int(s[0])
        if p["mode"] == "vi":
            if n_in < max(6, cfg.min_track_inliers // 2):
                self._rollback_pending(p)
                self._prev_match = None
                self.state = LOST
                self.n_lost_frames += 1
                self.events.append((p["frame_id"], "lost",
                                    dict(mode="vi", n_in=n_in)))
                return
        else:
            if n_in < cfg.min_track_inliers:
                # motion-prior-free fallback against the reference keyframe
                # (TrackReferenceKeyFrame, src/Tracking.cpp:1524) — host-side
                # (PnP RANSAC); rare, so the round trips are acceptable.
                # With newer frames in flight, their dispatches rode this
                # frame's (bad) pose: discard them too and re-track.
                res2 = self._track_reference_kf(p["feats"], p["uv"])
                if res2 is None:
                    self._rollback_pending(p)
                    self._prev_match = None
                    self.state = LOST
                    self.n_lost_frames += 1
                    self.events.append((p["frame_id"], "lost",
                                        dict(mode="vis", n_in=n_in)))
                    return
                n_in = int(res2.n_inliers)
                # newer in-flight frames rode the bad pose: drop them and
                # re-seat tracking on the fallback solution
                self.traj.truncate(p["row"] + 1)
                self.n_lost_frames += len(self._pendings)
                self._pendings.clear()
                P_last, R_last = p["pose_before"]
                RlT = jnp.swapaxes(R_last, -1, -2)
                self.velocity = ((RlT @ (res2.P - P_last)[..., None])[..., 0],
                                 RlT @ res2.R)
                self.last_pose = (res2.P, res2.R)
                self._cur_feat_mp = res2.feat_mp
                self._prev_match = (res2.feat_mp, p["feats"].angle)
                _, _, _, _, _, mf, mv, _ = p["backup"]
                vis_mask = jnp.zeros(self.m.P, bool).at[
                    jnp.clip(res2.feat_mp, 0, self.m.P - 1)].set(
                        res2.feat_mp >= 0, mode="drop")
                self.m = mapping.update_found_visible(
                    self.m._replace(mp_found=mf, mp_visible=mv),
                    vis_mask, vis_mask)
                k, kid = self._anchor_slot()
                row = self._traj_row_jit(self.m, res2.P, res2.R,
                                         jnp.asarray(max(k, 0), jnp.int32))
                self.traj.replace_at(p["row"], row)
                # the pending's dispatch-time snapshot holds the REJECTED
                # motion-model result; a keyframe created below must carry
                # the fallback solution (pose + associations), not the bad
                # one (ADVICE r4: map corruption exactly when the visual
                # bootstrap is struggling)
                p["pose"] = (res2.P, res2.R)
                p["feat_mp"] = res2.feat_mp
        self._cur_inliers = n_in
        if (not self.localization_only
                and p.get("epoch") == self._map_epoch
                and self._need_new_kf(fid=p["frame_id"])):
            with self.timers.stage("local_mapping"):
                with self.timers.stage("lm_insert"):
                    slot = self._create_keyframe(p["feats"], p["uv"], p["t"],
                                                 fid=p["frame_id"],
                                                 pose=p.get("pose"),
                                                 ns=p.get("ns"),
                                                 feat_mp=p.get("feat_mp"))
                self._local_mapping()
            # loop detection was dispatched at the event's end; its result is
            # harvested (and any closure applied) at the NEXT frame's harvest
            self._invalidate_frame_caches()
        if not self.vi_inited and cfg.use_imu:
            with self.timers.stage("vi_init"):
                self._maybe_vi_init(p["t"])
                if self.vi_inited:
                    self._invalidate_frame_caches()

    def _harvest_pair(self, p):
        """Deferred decisions for a fused two-frame dispatch: one summary
        pull covers both frames; LOST / keyframe checks run per sub-frame.
        A loss anywhere in the pair rolls back to the pre-pair state (losses
        are rare in VI steady state; the one extra dropped frame is cheaper
        than per-frame backups)."""
        cfg = self.cfg
        name = ("harvest_pull" if self._summary_ready(p)
                else "harvest_pull_block")
        with self.timers.stage(name):
            s2 = np.asarray(p["summary"])
        for i, fr in enumerate(p["frames"]):
            n_in = int(s2[i][0])
            if n_in < max(6, cfg.min_track_inliers // 2):
                self._rollback_pending(p)
                self._prev_match = None
                self.state = LOST
                self.n_lost_frames += len(p["frames"]) - i
                self.events.append((fr["frame_id"], "lost",
                                    dict(mode="vi2", n_in=n_in)))
                return
            self._cur_inliers = n_in
            if (not self.localization_only
                    and p.get("epoch") == self._map_epoch
                    and self._need_new_kf(fid=fr["frame_id"])):
                with self.timers.stage("local_mapping"):
                    with self.timers.stage("lm_insert"):
                        slot = self._create_keyframe(
                            fr["feats"], fr["uv"], fr["t"],
                            fid=fr["frame_id"], pose=fr["pose"],
                            ns=fr["ns"], feat_mp=fr["feat_mp"])
                    self._local_mapping()
                self._invalidate_frame_caches()

    def _harvest_event(self, force=False):
        """Harvest the deferred tail of the last keyframe event: post-BA
        redundancy stats (keyframe culling + the NeedNewKeyFrame reference
        count) and loop detection results (+ any closure). READINESS-GATED:
        consumed only once the async copies have landed (the event's device
        programs take ~hundreds of ms and tracking keeps dispatching against
        the in-flight map state meanwhile — the single-loop analog of the
        reference's LocalMapping/LoopClosing threads running behind Tracking,
        src/System.cpp:196-203). force=True blocks (flush, next event)."""
        ev = self._deferred_event
        if ev is None:
            return
        if not force:
            ev["age"] = ev.get("age", 0) + 1
            try:
                leaves = jax.tree_util.tree_leaves((ev["stats"], ev["detect"]))
                if not all(h.is_ready() for h in leaves):
                    return
            except Exception:
                # backend without is_ready: age-gate instead (consume a few
                # frames after dispatch, when the copies have likely landed,
                # rather than blocking the frame loop on the whole event chain)
                if ev["age"] < 4:
                    return
        self._deferred_event = None
        slot = ev["slot"]
        if "t_disp" in ev:
            # drain time of the whole keyframe-event device chain (dispatch
            # of the event's last program -> its stats copy landing): the
            # frame loop must absorb this much in-flight latency
            import time as _t
            self.timers.samples["ev_chain_drain"].append(
                _t.perf_counter() - ev["t_disp"])
        with self.timers.stage("lm_stats2"):
            covis2, red2, npts2, _, well2 = jax.device_get(ev["stats"])
        if slot in self.kf_slots:
            self._covis_row_cache = (slot, covis2)
            self._ref_tracked_cache = int(well2)
            with self.timers.stage("lm_cullkf"):
                self._cull_keyframes(red2, npts2)
        if ev["detect"] is not None and slot in self.kf_slots:
            with self.timers.stage("loop_closing"):
                self._try_close_loop(slot, handles=ev["detect"])
                if self.n_loops_closed and self._last_loop_nkf == self.n_kf:
                    self._invalidate_frame_caches()

    def flush(self):
        """Complete any in-flight frame and flush device trajectory rows.
        Call before reading system state externally."""
        self._harvest_pending(drain=True)
        self._harvest_event(force=True)
        self._harvest_sim3(force=True)
        while self._deferred_verify is not None:
            self._harvest_verify(force=True)
        self.traj.flush()

