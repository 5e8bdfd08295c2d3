"""Keyframe-event orchestration (SlamSystem mixin): covisibility queries,
local mapping, window/global BA entries, keyframe culling, IMU-chain
splicing (LocalMapping.cpp roles). Split from system.py (r4 verdict
item 9) - no behavior change.
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
                                            empty_map, observation_counts,
                                            scatter_slots)
from mc_slam.solver import ba, ba_chunked, ba_vi, ba_vi_idp, factors
from mc_slam.solver.ba import VisualObs


class MappingCtlMixin:
    # ------------------------------------------------------------------
    # Local mapping (synchronous, per new KF)
    # ------------------------------------------------------------------
    def _covis_row(self, slot):
        """Host copy of the covisibility weights row for `slot`, served from
        the per-KF-event stats pull when fresh (one round trip serves every
        neighbor query of the event)."""
        cache = getattr(self, "_covis_row_cache", None)
        if cache is not None and cache[0] == slot:
            return cache[1].copy()
        return np.array(covisibility_weights(self.m, slot))

    def _covisible(self, slot, n):
        """Top-n covisible keyframes with weight >= covis_th (the reference's
        UpdateConnections threshold 15, src/KeyFrame.cpp:668; falls back to the
        single best neighbor when nothing clears the bar, as the reference
        keeps the max-weight edge regardless)."""
        w = self._covis_row(slot)
        w[slot] = 0
        w = w * self._active_mask()
        order = np.argsort(-w)
        out = [int(k) for k in order[:n] if w[k] >= self.cfg.covis_th]
        if not out and w[order[0]] > 0:
            # nothing clears the bar: keep the single max-weight edge, as the
            # reference does in UpdateConnections (src/KeyFrame.cpp:690-696)
            out = [int(order[0])]
        return out

    def _active_mask(self):
        """(K,) host float mask of active keyframe slots (from kf_slots — no
        device pull)."""
        mask = np.zeros(self.cfg.max_kf, np.float32)
        mask[list(self.kf_slots)] = 1.0
        return mask

    def _covisible_stale(self, slot, n, strong=False):
        """Neighbor selection from the most recent covisibility row cache
        regardless of which keyframe produced it (consecutive keyframes share
        most of their covisibles): used where an exact fresh row would cost a
        blocking device pull mid-event. The cached row's own keyframe keeps
        its (inflated) self-weight and therefore ranks first — which is the
        desired fixed observer / window member anyway."""
        cache = getattr(self, "_covis_row_cache", None)
        if cache is None:
            return (self._covisible_strong(slot, n) if strong
                    else self._covisible(slot, n))
        w = cache[1].copy()
        w[slot] = 0
        w = w * self._active_mask()
        order = np.argsort(-w)
        out = [int(k) for k in order[:n] if w[k] >= self.cfg.covis_th]
        if not strong and not out and w[order[0]] > 0:
            out = [int(order[0])]
        return out

    def _covisible_strong(self, slot, n):
        """Covisible neighbors that clear covis_th — no max-weight fallback.
        Used where a weakly-connected neighbor would do harm (e.g. as the only
        gauge-fixing observer of a local BA window)."""
        w = self._covis_row(slot)
        w[slot] = 0
        w = w * self._active_mask()
        order = np.argsort(-w)
        return [int(k) for k in order[:n] if w[k] >= self.cfg.covis_th]

    def _local_mapping(self):
        cfg = self.cfg
        slot = self.last_kf_slot
        # a previous event's deferred tail must be consumed before this event
        # overwrites it (forced: blocks if its copies haven't landed yet)
        self._harvest_event(force=True)
        # pre-BA half as ONE program: landmark cull/evict (occupancy
        # decisions in-graph), device-side neighbor selection, scanned
        # triangulation + fusion (mapping.kf_event_pre) — the split form was
        # 4 dispatches each paying a host round trip
        with self.timers.stage("lm_pre"):
            self.m, nb4, nbv4, wslots, wvalid = mapping.kf_event_pre(
                self.m, jnp.asarray(slot, jnp.int32),
                jnp.asarray(self.frame_id),
                self.cam, self.ext, jnp.asarray(cfg.n_levels, jnp.int32),
                min_obs=cfg.cull_min_obs, n_evict=int(0.07 * self.m.P),
                covis_th=cfg.covis_th)
        with self.timers.stage("lm_ba"):
            self._local_ba()
        # post-BA half as ONE program: point-stat refresh (AFTER the BA on
        # purpose — BA slides low-parallax landmarks along their rays and the
        # scale-band gate needs current bands), redundancy/ref-tracked stats,
        # and loop-detection scores sharing one (K,P) observation build.
        # DISPATCH-ONLY: harvested when the async copies land
        # (readiness-gated, see _harvest_event).
        with self.timers.stage("lm_post"):
            do_detect = self._loop_gates_open()
            m2, stats2, scores, Wc = mapping.kf_event_post(
                self.m, jnp.asarray(slot, jnp.int32), wslots, wvalid,
                self.ext, self.loop.hists,
                jnp.asarray(cfg.n_levels, jnp.int32),
                min_obs=(2 if len(self.kf_slots) <= 2 else 3),
                refresh=cfg.refresh_stats)
            self.m = m2
            detect_h = (scores, Wc) if do_detect else None
            if do_detect:
                # dispatch-time snapshot for the stale-histogram guard
                self.loop._dispatch_ids = dict(self.loop.hist_ids)
        for h in jax.tree_util.tree_leaves((stats2, detect_h)):
            try:
                h.copy_to_host_async()
            except Exception:
                pass
        import time as _t
        self._deferred_event = {"slot": slot, "stats": stats2,
                                "detect": detect_h,
                                "t_disp": _t.perf_counter()}
        # keep the tracking state synced to the (BA-updated) newest KF
        self.last_pose = self._kf_body_pose(slot)
        if self.vi_inited:
            self.last_ns = jax.tree_util.tree_map(
                lambda a: a[slot], self.m.kf_ns)
            self.prior = None          # marginal prior is stale after map update
            # re-integrate from the keyframe over any rows newer than its
            # cut (frames already in flight when the event ran)
            self.imu_since_frame = list(self.imu_since_kf)

    def _ba_window_slots(self):
        """Window for local BA: covisible KFs (visual) or the KF chain (VI).

        The VI window never extends back across a broken IMU chain
        (AddToLocalWindow restart semantics, src/LocalMapping.cpp:897-916): a
        window mixing pre-gap and post-gap keyframes with the connecting
        PRV/bias edges disabled leaves the newer island's biases anchored by
        nothing but weak visual roll information, and they diverge."""
        cfg = self.cfg
        slot = self.last_kf_slot
        if self.vi_inited:
            act = list(self.kf_slots)
            w = act[-cfg.local_window:]
            for i in range(len(w) - 1, 0, -1):
                if w[i] in self.broken_chain_slots:
                    w = w[i:]
                    break
            return w
        window = [slot] + self._covisible_stale(slot, cfg.ba_window - 1)
        # the previous keyframe is always a window member (consecutive-KF
        # covisibility; with a stale neighbor row it can be missing)
        if len(self.kf_slots) >= 2:
            prev = self.kf_slots[-2]
            if prev not in window:
                window = window[:cfg.ba_window - 1] + [prev]
        return window

    def _gather_obs(self, window, fixed):
        """Build a VisualObs batch from the observation tables of `window+fixed`
        keyframes (local index space)."""
        all_slots = window + fixed
        ks = jnp.asarray(all_slots, jnp.int32)
        Fn = self.m.F
        n = len(all_slots)
        cam_idx = jnp.repeat(jnp.arange(n, dtype=jnp.int32), Fn)
        mp = self.m.kf_mp[ks].reshape(-1)
        uv = self.m.kf_uv[ks].reshape(-1, 2)
        lvl = self.m.kf_level[ks].reshape(-1)
        fv = self.m.kf_feat_valid[ks].reshape(-1)
        valid = (mp >= 0) & fv
        obs = VisualObs(
            cam=cam_idx, pt=jnp.clip(mp, 0, self.m.P - 1), uv=uv,
            inv_sigma2=1.0 / (1.2 ** (2.0 * lvl.astype(jnp.float32))),
            valid=valid.astype(jnp.float32),
            ur=(self.m.kf_ur[ks].reshape(-1) if self.sensor_depth else None))
        return obs

    def _local_ba(self, force_all=False, prune=True):
        cfg = self.cfg
        if force_all:
            window = list(self.kf_slots)
            if len(window) > 40:
                # large map: landmark-chunked Schur at padded shapes (dense
                # Wcp would be O(Nc*DC*Np*DP) — GBA must stay O(map))
                return self._global_ba_chunked(window, prune=prune)
            fixed = []
            # bucket-pad even the "rare" whole-map call: device compiles are
            # expensive, and VI init runs this once per new keyframe while it
            # polls
            pad_to = int(np.ceil(len(window) / 8)) * 8
        else:
            window = self._ba_window_slots()
            # fixed observers: covisible KFs not in the window (strong edges
            # only — a weight-1 observer must not serve as the gauge anchor)
            fixed = [s for s in
                     self._covisible_stale(self.last_kf_slot,
                                           cfg.ba_window + 6, strong=True)
                     if s not in window][:4]
            # VI: the window front's chain predecessor joins as a FIXED vertex
            # carrying its PRV+bias edge into the window (pKFPrevLocal,
            # src/Optimizer.cpp LocalBAPRVIDP) — without it the window's bias
            # chain has no anchor to history and its weakly-observed axes walk
            prev_kf = None
            if self.vi_inited and window[0] not in self.broken_chain_slots:
                act = list(self.kf_slots)
                wi = act.index(window[0])
                if wi > 0:
                    prev_kf = act[wi - 1]
                    fixed = [prev_kf] + [s for s in fixed if s != prev_kf][:3]
            pad_to = max(cfg.ba_window, cfg.local_window) + 4  # ONE jit shape
        if len(window) < 2:
            return
        all_slots = window + fixed
        n_real = len(all_slots)
        if pad_to is not None and n_real < pad_to:
            all_slots = all_slots + [all_slots[-1]] * (pad_to - n_real)
        free = np.zeros(len(all_slots), np.float32)
        free[:len(window)] = 1.0
        # gauge: when no out-of-window observers anchor the problem, fix the
        # oldest window KF (reference fixes KF0 / the second-ring, and monocular
        # scale gauge is additionally damped by LM)
        if not fixed:
            free[0] = 0.0
        ks = jnp.asarray(all_slots, jnp.int32)
        put = scatter_slots(ks, n_real, self.m.K)
        if self.vi_inited:
            prev_idx = (len(window) if not force_all and prev_kf is not None
                        else None)
            # a window that STARTS at a chain break (post-reloc island) has no
            # history edge anchoring its bias chain: weakly-observed bias axes
            # (optical-axis gyro bias under low roll texture) random-walk and
            # can diverge. Pin the front keyframe's biases to their current
            # (reloc-window-recomputed) values with a weak prior.
            prior = None
            if not force_all and window[0] in self.broken_chain_slots:
                info = np.zeros((15, 15), np.float32)
                info[9:12, 9:12] = np.eye(3) / 2e-3 ** 2
                info[12:15, 12:15] = np.eye(3) / 2e-2 ** 2
                prior = ba_vi.PriorFactor(
                    cam=jnp.asarray(0, jnp.int32),
                    ns0=jax.tree_util.tree_map(lambda a: a[window[0]],
                                               self.m.kf_ns),
                    info=jnp.asarray(info), valid=jnp.asarray(1.0, jnp.float32))
            if cfg.use_idp_ba and not self.sensor_depth and not force_all:
                # flagship VI back end: anchored inverse-depth window BA
                # (LocalBAPRVIDP parity; DP=1 shrinks the landmark system 3x)
                # as ONE fused device program over the MapState — gather,
                # edge assembly, landmark-compacted solve, scatter-back, and
                # the chi2 prune (the eager form cost ~25 dispatches/event)
                ii, jj, ev = self._imu_edge_lists(
                    all_slots, len(window), prev_idx=prev_idx,
                    n_pad=len(all_slots))
                self.m = ba_vi_idp.window_vi_ba_map(
                    self.m, ks, jnp.asarray(ii), jnp.asarray(jj),
                    jnp.asarray(ev), jnp.asarray(n_real, jnp.int32),
                    jnp.asarray(free), self.cam, self.ext, self.gw,
                    float(self.noise.sigma_bg), float(self.noise.sigma_ba),
                    prior=prior, iters=8, rtol=cfg.ba_rtol,
                    Pw=min(4096, self.m.P), do_prune=prune)
                return
            obs = self._gather_obs(window, fixed + all_slots[n_real:])
            if len(all_slots) > n_real:
                obs = obs._replace(
                    valid=obs.valid * (obs.cam < n_real).astype(obs.valid.dtype))
            ns_w = jax.tree_util.tree_map(lambda a: a[ks], self.m.kf_ns)
            edges = self._imu_edges(all_slots, len(window), prev_idx=prev_idx,
                                    n_pad=len(all_slots))
            ns2, pts2, chi2, cost = ba_vi.vi_ba(
                ns_w, self.m.mp_pos, obs, edges, self.cam, self.ext, self.gw,
                jnp.asarray(free), self.m.mp_active.astype(jnp.float32),
                prior=prior, iters=8, bf=self._bf,
                rtol=0.0 if force_all else cfg.ba_rtol,
                two_phase=not force_all)
            self.m = self.m._replace(
                kf_ns=jax.tree_util.tree_map(
                    lambda full, w: full.at[put].set(w, mode="drop"),
                    self.m.kf_ns, ns2),
                mp_pos=pts2)
        else:
            obs = self._gather_obs(window, fixed + all_slots[n_real:])
            if len(all_slots) > n_real:
                obs = obs._replace(
                    valid=obs.valid * (obs.cam < n_real).astype(obs.valid.dtype))
            P0 = self.m.kf_ns.P[ks]
            R0 = self.m.kf_ns.R[ks]
            # windowed: reference local-BA protocol (outlier round; skipped
            # in abortable mode rtol>0). force_all: reference GBA = single
            # Huber run, no outlier round (src/Optimizer.cpp:3346/:629).
            P2, R2, pts2, chi2, cost = ba.visual_ba(
                P0, R0, self.m.mp_pos, obs, self.cam, self.ext,
                jnp.asarray(free), self.m.mp_active.astype(jnp.float32), iters=10,
                bf=self._bf, rtol=0.0 if force_all else cfg.ba_rtol,
                two_phase=not force_all)
            ns = self.m.kf_ns
            self.m = self.m._replace(
                kf_ns=ns._replace(P=ns.P.at[put].set(P2, mode="drop"),
                                  R=ns.R.at[put].set(R2, mode="drop")),
                mp_pos=pts2)
        # remove outlier associations (chi2 gate) — skipped right after a loop
        # correction, where residuals are still settling and a mass prune would
        # destroy map connectivity
        if prune:
            self._prune_obs(all_slots, n_real, obs, chi2)

    def enable_mesh(self, mesh=None, mesh_e=None):
        """Route whole-map optimizations through a device mesh: the chunked
        GBA becomes landmark-sharded (parallel/dist_gba: per-device Schur
        partials + one psum of the reduced camera system per iteration) and
        the loop essential graph becomes edge-sharded
        (parallel/dist_posegraph). Call with no args to use all visible
        devices; no-op on a single device. This is the pipeline wiring of
        SURVEY.md §2.4's north star — the distributed solvers serve the real
        map, not a demo problem."""
        from mc_slam.parallel import dist_ba
        if mesh is None:
            n = len(jax.devices())
            if n <= 1:
                return
            mesh = dist_ba.make_mesh(n)
            mesh_e = dist_ba.make_mesh(n, axis="e")
        self.mesh = mesh
        self.mesh_e = mesh_e

    def _global_ba_chunked(self, window, prune=True, kf_pad=32, chunk=1024):
        """Whole-map BA via ba_chunked (GlobalBundleAdjustment[NavStatePRV],
        src/Optimizer.cpp:3346/:629) — used beyond ~40 keyframes where the
        dense landmark system stops fitting the memory/compile budget.
        With enable_mesh, the VI form runs landmark-sharded over the mesh."""
        n_real = len(window)
        pad_n = int(np.ceil(n_real / kf_pad)) * kf_pad
        all_slots = window + [window[-1]] * (pad_n - n_real)
        ks = jnp.asarray(all_slots, jnp.int32)
        put = scatter_slots(ks, n_real, self.m.K)
        obs = self._gather_obs(window, all_slots[n_real:])
        # padded slots contribute no constraints (device-side mask)
        obs = obs._replace(
            valid=obs.valid * (obs.cam < n_real).astype(obs.valid.dtype))
        free = np.zeros(pad_n, np.float32)
        free[1:n_real] = 1.0               # gauge: oldest KF fixed
        n_chunks = max(1, self.m.P // chunk)
        if self.mesh is not None:
            # chunk count must divide the mesh (empty pad chunks are no-ops)
            nd = int(self.mesh.devices.size)
            n_chunks = int(np.ceil(n_chunks / nd)) * nd
        cobs, C = ba_chunked.chunk_observations(
            np.asarray(obs.cam), np.asarray(obs.pt), np.asarray(obs.uv),
            np.asarray(obs.inv_sigma2), np.asarray(obs.valid), self.m.P,
            n_chunks, ur=None if obs.ur is None else np.asarray(obs.ur))
        pt_mask = self.m.mp_active.astype(jnp.float32)
        if self.vi_inited:
            ns_w = jax.tree_util.tree_map(lambda a: a[ks], self.m.kf_ns)
            edges = self._imu_edges(all_slots, n_real, n_pad=pad_n)
            if self.mesh is not None:
                from mc_slam.parallel import dist_gba
                cobs_s = dist_gba.shard_chunked_obs(self.mesh, cobs)
                ns2, pts2, cost = dist_gba.vi_gba_chunked_sharded(
                    self.mesh, ns_w, self.m.mp_pos, cobs_s, edges, self.cam,
                    self.ext, self.gw, jnp.asarray(free), pt_mask, iters=8,
                    bf=self._bf)
            else:
                ns2, pts2, cost = ba_chunked.vi_gba_chunked(
                    ns_w, self.m.mp_pos, cobs, edges, self.cam, self.ext,
                    self.gw, jnp.asarray(free), pt_mask, iters=8, bf=self._bf)
            self.m = self.m._replace(
                kf_ns=jax.tree_util.tree_map(
                    lambda full, w: full.at[put].set(w, mode="drop"),
                    self.m.kf_ns, ns2),
                mp_pos=pts2)
        else:
            P0 = self.m.kf_ns.P[ks]
            R0 = self.m.kf_ns.R[ks]
            P2, R2, pts2, cost = ba_chunked.visual_gba_chunked(
                P0, R0, self.m.mp_pos, cobs, self.cam, self.ext,
                jnp.asarray(free), pt_mask, iters=10, bf=self._bf)
            ns = self.m.kf_ns
            self.m = self.m._replace(
                kf_ns=ns._replace(P=ns.P.at[put].set(P2, mode="drop"),
                                  R=ns.R.at[put].set(R2, mode="drop")),
                mp_pos=pts2)
        if prune:
            # per-obs chi2 in one flat pass (no Schur structures involved)
            ns = self.m.kf_ns
            P_o = ns.P[ks][obs.cam]
            R_o = ns.R[ks][obs.cam]
            r, _, _, z = factors.reproj_xyz(self.cam, self.ext, P_o, R_o,
                                            self.m.mp_pos[obs.pt], obs.uv)
            chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
            chi2 = jnp.where(z > 0, chi2, jnp.full_like(chi2, 1e9))
            self._prune_obs(all_slots, n_real, obs, chi2)

    def _vi_idp_ba(self, ks, ns_w, edges, obs, free, prior=None):
        """Anchored inverse-depth VI window BA (Optimizer::LocalBAPRVIDP,
        src/Optimizer.cpp:32-630): one fused landmark-compacted device
        program (ba_vi_idp.vi_window_ba). The window references a few
        thousand landmarks; solving in full-table index space would make
        every Schur/scatter op pay for all 16k slots."""
        return ba_vi_idp.vi_window_ba(
            ns_w, self.m.mp_pos, self.m.mp_active, obs.pt, obs.cam, obs.uv,
            obs.inv_sigma2, obs.valid, edges, self.cam, self.ext, self.gw,
            free, prior=prior, iters=8, rtol=self.cfg.ba_rtol,
            Pw=min(4096, self.m.P))

    def _prune_obs(self, slots, n_real, obs, chi2):
        gate = jnp.asarray(ba.CHI2_MONO) if obs.ur is None else \
            jnp.where(obs.ur >= 0, ba.CHI2_STEREO, ba.CHI2_MONO)
        self.m = mapping.prune_associations(
            self.m, jnp.asarray(slots, jnp.int32), chi2, obs.valid, gate,
            n_real)

    def _imu_edges(self, all_slots, n_window, prev_idx=None, n_pad=None):
        """PRV edges along consecutive window KFs (local index space).

        prev_idx: optional local index of the window front's (fixed) chain
        predecessor — adds the predecessor->front edge (the window front's own
        stored preintegration), anchoring the window's bias chain to history
        (pKFPrevLocal edge, src/Optimizer.cpp LocalBAPRVIDP).

        n_pad: structural edge-list length (defaults to n_window). The edge
        count must be a function of the PADDED window size, not the live one,
        or every window-size change recompiles the whole BA program — fatal
        when device compiles are expensive. The prev-edge slot is always
        present structurally (valid=0 when unused) for the same reason."""
        n_pad = n_pad if n_pad is not None else n_window
        idx_i, idx_j, ev = self._imu_edge_lists(all_slots, n_window,
                                                prev_idx=prev_idx, n_pad=n_pad)
        slots_j = [all_slots[b] for b in idx_j]
        # one batched gather per preint leaf (a per-edge tree_map issues
        # hundreds of tiny device ops)
        ksj = jnp.asarray(slots_j, jnp.int32)
        pre = jax.tree_util.tree_map(lambda x: x[ksj], self.m.kf_preint)
        info_prv = factors.imu_prv_info(pre)
        info_bias = factors.bias_rw_info(pre.dT, float(self.noise.sigma_bg),
                                         float(self.noise.sigma_ba))
        evj = jnp.asarray(ev, jnp.float32)
        # a structurally-present but masked edge can carry a degenerate preint
        # (dT=0 identity) whose info is inf/NaN; 0 * inf = NaN would poison the
        # system, so replace masked-edge infos with identity
        sel = evj[:, None, None] > 0
        info_prv = jnp.where(sel, info_prv, jnp.eye(9, dtype=info_prv.dtype))
        info_bias = jnp.where(sel, info_bias, jnp.eye(6, dtype=info_bias.dtype))
        return ba_vi.IMUEdges(
            i=jnp.asarray(idx_i, jnp.int32), j=jnp.asarray(idx_j, jnp.int32),
            pre=pre, info_prv=info_prv, info_bias=info_bias,
            valid=evj)

    def _imu_edge_lists(self, all_slots, n_window, prev_idx=None, n_pad=None):
        """(idx_i, idx_j, ev) host edge-index lists for the window chain.
        Slot 0: predecessor edge (structural; masked off when prev_idx None);
        then consecutive-pair edges, valid only inside the real window and
        never across a broken IMU chain."""
        n_pad = n_pad if n_pad is not None else n_window
        idx_i = [prev_idx if prev_idx is not None else 0]
        idx_j = [0]
        ev = [1.0 if (prev_idx is not None
                      and all_slots[0] not in self.broken_chain_slots) else 0.0]
        for a, b in zip(range(n_pad - 1), range(1, n_pad)):
            idx_i.append(a)
            idx_j.append(b)
            ev.append(1.0 if (b < n_window
                              and all_slots[b] not in self.broken_chain_slots)
                      else 0.0)
        return (np.asarray(idx_i, np.int32), np.asarray(idx_j, np.int32),
                np.asarray(ev, np.float32))

    def _cull_keyframes(self, ratio_all=None, npts_all=None):
        """90% redundancy rule with VI time-gap guards (src/LocalMapping.cpp:1777):
        never cull within 0.11 s of the current KF; gap(next, prev) must stay
        under 0.51 s, relaxed to 3.01 s for VI-inited KFs older than 4 s; the
        local-window front and its predecessor are protected."""
        t_cur = self.kf_time_host[self.last_kf_slot]
        # redundancy for every KF in ONE batched pass per removal round:
        # each removal changes observation counts, so recompute before
        # accepting the next candidate (matches the reference's sequential
        # reevaluation) — zero-removal events reuse the event's stats pull
        first = True
        while True:
            active = list(self.kf_slots)
            # loop-edge carriers are never culled (SetNotErase semantics)
            protected = {s for e in self.loop_edges for s in e[:2]}
            if self.cfg.use_imu and len(active) > self.cfg.local_window:
                wfront = len(active) - self.cfg.local_window
                protected |= {active[wfront], active[wfront - 1]}
            # recent keyframes are the live triangulation partners: culling
            # one drops its brand-new points below min_obs and the landmark
            # cull erases them before they mature — under fast panning this
            # starves tracking into a loss spiral (r4 regression: the async
            # event pipeline made culling fire a frame later, exactly when
            # the next KF's points were 1-observation young). The reference's
            # equivalent protection is implicit: its redundancy test demands
            # >= 3 observers AT OR FINER SCALE, which new points near the
            # sweep head never satisfy (src/LocalMapping.cpp:1777-1914).
            # Depth 8 (the visual BA window) verified: 4 still spirals on the
            # fast-pan loop world; culling is only DELAYED until a KF leaves
            # the window.
            protected |= set(active[-max(8, self.cfg.ba_window):])
            if first and ratio_all is not None:
                first = False
            else:
                ratio_all, npts_all = map(np.asarray,
                                          mapping.kf_redundancy_all(self.m))
            removed = False
            for i, s in enumerate(active[1:-1], start=1):
                if s in protected:
                    continue
                if self.cfg.use_imu:
                    t_prev = self.kf_time_host[active[i - 1]]
                    t_next = self.kf_time_host[active[i + 1]]
                    t_s = self.kf_time_host[s]
                    if t_s >= t_cur - 0.11:
                        continue
                    timegap = 0.51
                    if self.vi_inited and t_s < t_cur - 4.0:
                        timegap = 3.01
                    if t_next - t_prev > timegap:
                        continue
                if ratio_all[s] > 0.9 and npts_all[s] > 20:
                    self._remove_keyframe(s)
                    removed = True
                    break
            if not removed:
                break

    def _splice_imu_chain(self, slot):
        """On KF removal, merge its raw IMU into the next KF and re-preintegrate
        (KeyFrame::SetBadFlag splicing, src/KeyFrame.cpp:1028-1030)."""
        if not self.cfg.use_imu:
            return
        act = self.kf_slots
        i = act.index(slot)
        if i + 1 >= len(act):
            return
        nxt = act[i + 1]
        merged = np.concatenate(
            [self.kf_imu_raw.get(slot, np.zeros((0, 7), np.float32)),
             self.kf_imu_raw.get(nxt, np.zeros((0, 7), np.float32))], 0)
        self.kf_imu_raw[nxt] = merged
        bg = self.m.kf_ns.bg[nxt] + self.m.kf_ns.dbg[nxt]
        ba_ = self.m.kf_ns.ba[nxt] + self.m.kf_ns.dba[nxt]
        pre = self._preintegrate_raw(merged, bg, ba_)
        self.m = self.m._replace(kf_preint=jax.tree_util.tree_map(
            lambda a, b: a.at[nxt].set(b), self.m.kf_preint, pre))

