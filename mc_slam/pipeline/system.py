"""SLAM system facade + host orchestrator.

Replaces System (src/System.cpp) and the thread state machines of Tracking /
LocalMapping (src/Tracking.cpp:799-1228, src/LocalMapping.cpp:988-1099) with a
deterministic single-loop pipeline (the reference's non-realtime mode,
test.RealTime: 0): per frame — extract, track; per keyframe — map-point culling,
triangulation with neighbors, fusion, local BA, keyframe culling; VI
initialization after enough keyframe baseline. The map lives on device as a
MapState; the host holds only scalars and small python state (state machine,
cursors, IMU buffers).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.camera import Camera, undistort_points
from mc_slam.frontend import extractor, matching
from mc_slam.frontend.extractor import Features
from mc_slam.geometry import init2view
from mc_slam.imu.navstate import NavState, navstate_identity
from mc_slam.imu.preintegration import (IMUNoise, euroc_noise, preint_identity,
                                            preintegrate, predict_navstate)
from mc_slam.frontend import bow
from mc_slam.geometry import pnp
from mc_slam.pipeline import loopclosing, mapping, tracking, viinit
from mc_slam.pipeline.frameloop import FrameLoopMixin
from mc_slam.pipeline.loopctl import LoopCtlMixin
from mc_slam.pipeline.mapping_ctl import MappingCtlMixin
from mc_slam.pipeline.pipebase import (NO_IMAGES_YET, NOT_INITIALIZED, OK,
                                           LOST)
from mc_slam.pipeline.tracking_ctl import TrackingCtlMixin
from mc_slam.pipeline.trajstore import TrajStore
from mc_slam.pipeline.viinit_ctl import VIInitMixin
from mc_slam.solver import ba_chunked, ba_vi_idp
from mc_slam.slam_map.mapstate import (MapState, covisibility_weights,
                                            empty_map, observation_counts)
from mc_slam.solver import ba, ba_vi, factors
from mc_slam.solver.ba import VisualObs

@dataclasses.dataclass
class SlamConfig:
    max_kf: int = 128
    max_mp: int = 4096
    n_feat: int = 512
    n_levels: int = 4
    local_window: int = 10          # VI local window (EuRoC uses 20)
    ba_window: int = 8              # covisible KFs in visual local BA
    min_init_matches: int = 60
    min_track_inliers: int = 12
    kf_min_gap: int = 3             # frames
    kf_max_gap: int = 20
    kf_ref_ratio: float = 0.8       # NeedNewKeyFrame ratio (src/Tracking.cpp:1865)
    covis_th: int = 15              # covisibility edge weight (src/KeyFrame.cpp:668)
    max_imu_per_kf: int = 256
    vi_init_time: float = 15.0      # seconds (config/euroc.yaml:6)
    vi_init_max_cond: float = 5e4   # step-3 system condition-number acceptance
    vi_init_scale_tol: float = 0.5  # |s - s_star| / s agreement (steps 2 vs 3)
    g_mag: float = 9.81
    use_imu: bool = False
    # VI local-window BA uses the anchored inverse-depth form (the reference's
    # production back end, LocalBAPRVIDP src/Optimizer.cpp:32); XYZ remains for
    # visual-only, global, and depth-sensor problems
    use_idp_ba: bool = True
    # early-termination threshold for window-BA LM iterations: once an accepted
    # step improves cost by < ba_rtol relative, the remaining scan iterations
    # no-op (the synchronous analog of the reference's mbAbortBA budget,
    # src/LocalMapping.cpp:1112). 0 disables. CAUTION: monocular-VI scale is a
    # low-gradient mode — relative-cost early exit can leave it under-
    # converged every window and the map scale drifts; keep 0 unless the
    # mapping budget demands it.
    ba_rtol: float = 0.0
    # per-frame pose-only LM early-exit (same mechanism, tracking path)
    track_rtol: float = 0.0
    # refresh distinctive descriptors + normals/scale ranges after fusion
    refresh_stats: bool = True
    stereo_baseline: float = 0.11   # meters (EuRoC-like rig)
    cull_min_obs: int = 3           # 3 mono, 2 for depth sensors (nThObs)
    seed: int = 0


class SlamSystem(FrameLoopMixin, TrackingCtlMixin, MappingCtlMixin,
                 LoopCtlMixin, VIInitMixin):
    """Monocular (+IMU) SLAM engine. Feed frames with `track(img, t[, imu])`.

    The orchestration lives in role mixins (frameloop / tracking_ctl /
    mapping_ctl / loopctl / viinit_ctl) split along the reference's thread
    boundaries (Tracking / LocalMapping / LoopClosing / VI-init,
    src/System.cpp:191-228); this class holds construction, the per-frame
    entry, initialization paths, and the keyframe data model."""

    def __init__(self, cam: Camera, cfg: SlamConfig = None,
                 Tbc: Optional[np.ndarray] = None, noise: IMUNoise = None):
        self.cam = cam
        self.cfg = cfg or SlamConfig()
        self._Tbc = Tbc
        self.ext = (factors.extrinsics_from_Tbc(Tbc) if Tbc is not None
                    else factors.identity_extrinsics())
        self.noise = noise or euroc_noise()
        self.m = empty_map(self.cfg.max_kf, self.cfg.max_mp, self.cfg.n_feat)
        self.state = NO_IMAGES_YET
        self.key = jax.random.PRNGKey(self.cfg.seed)

        # host bookkeeping
        self.frame_id = 0
        self.n_kf = 0
        self.last_kf_slot = -1
        self.last_kf_frame = 0
        self.kf_slots: list[int] = []        # active slots in insertion order
        self.free_slots: list[int] = []      # culled slots available for reuse
        self.next_fresh_slot = 0             # high-water mark of slot allocation
        self.kf_imu_raw: dict[int, np.ndarray] = {}  # slot -> (T,7) since prev KF
        # host mirrors of immutable per-KF scalars (each bool()/float()/int()
        # on a device element is a blocking device->host round trip)
        self.kf_time_host: dict[int, float] = {}
        self.kf_id_host: dict[int, int] = {}

        # per-frame state
        self.sensor_depth = False       # becomes True in stereo/RGB-D mode
        self.init_feats: Features | None = None
        self.init_uv: jnp.ndarray | None = None
        self.last_feats: Features | None = None
        # (feat_mp, feat_angle) of the last successfully tracked frame: the
        # angle source for the frame-to-frame rotation-consistency prune
        # (tracking.last_frame_angles); None disables the prune for one frame
        # (first frame, after loss/reloc)
        self._prev_match = None
        self.last_pose = (jnp.zeros(3), jnp.eye(3))   # body P, R (world-from-body)
        self.last_ns: NavState = navstate_identity()
        self.velocity = (jnp.zeros(3), jnp.eye(3))    # relative motion model
        self.last_time = 0.0

        # VI state
        self.vi_inited = False
        self.gw = jnp.asarray([0.0, 0.0, -self.cfg.g_mag])
        # (frame_id, rows) blocks: deferred keyframe cuts take exactly the
        # rows with frame_id <= the keyframe's frame (see _insert_kf_raw)
        self.imu_since_kf: list[tuple[int, np.ndarray]] = []
        self.imu_since_frame: list[tuple[int, np.ndarray]] = []
        self.first_kf_time = None
        self.prior: ba_vi.PriorFactor | None = None
        # post-relocalization bias re-estimation window (the reference's
        # mbRelocBiasPrepare 20-frame buffer, src/Tracking.cpp:47-220,1075-1106)
        self.reloc_buf: list | None = None
        self.reloc_window = 20
        # KF slots whose preintegration-from-previous spans a reloc gap: their
        # PRV/bias edges are disabled (the raw IMU across a kidnap/dropout is
        # not a valid constraint)
        self.broken_chain_slots: set[int] = set()
        self._chain_break_pending = False

        # per-frame trajectory stored RELATIVE to the reference keyframe at
        # track time (Tracking::mlRelativeFramePoses, src/Tracking.cpp:279 and
        # System::SaveTrajectoryTUM): composing against the CURRENT keyframe
        # poses at save time propagates VI-init rescaling, loop corrections,
        # and GBA refinements to every past frame. Rows live on DEVICE
        # (TrajStore) — a per-frame host pull would be a device round trip.
        self.traj = TrajStore()
        # in-flight fused frame steps, oldest first (see _harvest_pending).
        # A frame's summary is consumed once its async device->host copy has
        # landed, so the hot loop does not wait for it (an immediate pull
        # waits for dispatch, compute and copy)
        import collections
        self._pendings: "collections.deque[dict]" = collections.deque()
        # Pipeline depth is ADAPTIVE between LAG_MIN and LAG_MAX: a frame is
        # harvested once its summary copy has actually landed (is_ready), so
        # the depth self-tunes to the device's real dispatch->result latency.
        # LAG_MAX bounds decision staleness (keyframe insertion / LOST
        # detection at most LAG_MAX frames late); LAG_MIN keeps the floor so
        # decision latency stays minimal when the device is the bottleneck.
        # LAG_MIN=1: harvest an entry as soon as its summary copy has landed
        # (is_ready) — with readiness gating an eager harvest never blocks,
        # and decisions (LOST, keyframe) land at minimum latency. Entries
        # may be two-frame pairs, so a count of 2 would double loss-surface
        # latency (tests pin it at <= 3 frames, the reference's immediacy).
        self.LAG_MIN = 1
        import os as _os
        # depth 12 (pairs): the loop may only block once the pipeline is
        # genuinely full, so a whole keyframe event can sit behind 24 frames
        # of dispatches. Its value on the GPU is not measured yet.
        self.LAG_MAX = int(_os.environ.get("MC_SLAM_LAG_MAX", "12"))
        # frames fused per dispatch post-VI-init (frame_pipeline_vi_pair):
        # fewer dispatch->result round trips per frame
        self.PAIR = int(_os.environ.get("MC_SLAM_PAIR", "2"))
        self._pair_buf: list | None = None
        # deferred tail of the last keyframe event (stats + loop detection)
        self._deferred_event: dict | None = None
        # in-flight Sim3 RANSAC batch for loop candidates (_harvest_sim3)
        self._deferred_sim3: dict | None = None
        # in-flight guided-verification count (_harvest_verify)
        self._deferred_verify: dict | None = None
        self._map_epoch = 0
        self.n_lost_frames = 0
        # diagnostic event log: (frame_id, kind, detail) — closures, losses,
        # relocalizations, VI init (the reference's cout breadcrumbs)
        self.events: list[tuple] = []

        # place recognition (loop closing + relocalization): the shipped
        # trained vocabulary when present (assets/vocab.npz), else random
        self.loop = loopclosing.LoopDetector(
            bow.load_default_vocab(jax.random.PRNGKey(self.cfg.seed + 1)),
            self.cfg.max_kf, idf=bow.load_default_idf())
        self.n_loops_closed = 0
        # persistent loop edges [(slot_a, slot_b)]: every accepted closure,
        # re-included in each subsequent essential-graph optimization
        # (LoopClosing.cpp:710-711, Optimizer.cpp:4413-4420); the KFs carrying
        # them are protected from culling (the reference's SetNotErase)
        self.loop_edges: list[tuple[int, int]] = []
        self.enable_loop_closing = True
        self.localization_only = False   # Activate/DeactivateLocalizationMode

        # device meshes for distributed whole-map optimization (enable_mesh):
        # None = single-device (the default); set = landmark-sharded GBA +
        # edge-sharded essential graph run through jax.sharding collectives
        self.mesh = None          # 1-D "mp" mesh (landmark chunks)
        self.mesh_e = None        # 1-D "e" mesh (pose-graph edges)

        # observability (SURVEY.md section 5): per-stage timers + optional
        # VI-init diagnostic file streaming (plotinit.py-compatible)
        from mc_slam.utils.metrics import StageTimer
        self.timers = StageTimer()
        # per-frame constants staged once (every eager jnp.asarray is a
        # host->device upload)
        self._c0i = jnp.asarray(0, jnp.int32)
        self._c1f = jnp.asarray(1.0, jnp.float32)
        self._fresh_fb = jnp.asarray(self._fresh_prior_info(1e2), jnp.float32)
        self._prior_fresh_1e3 = jnp.asarray(self._fresh_prior_info(1e3),
                                            jnp.float32)
        self._zero_fmp = jnp.full(self.cfg.n_feat, -1, jnp.int32)
        self._zero_ang = jnp.zeros(self.cfg.n_feat, jnp.float32)
        self._cur_feat_mp = self._zero_fmp
        self._cur_inliers = 0
        self.viinit_log = None      # set to utils.metrics.VIInitLog(dir) to enable

    # ------------------------------------------------------------------
    @property
    def _bf(self):
        """fx * baseline (the reference's mbf)."""
        return float(self.cam.fx) * self.cfg.stereo_baseline

    def _undistort(self, feats: Features):
        return undistort_points(self.cam, feats.xy)

    def upload(self, img):
        """Asynchronously stage a frame on the device ahead of `track`.

        Returns a device array that `track` accepts directly. uint8 input is
        uploaded as-is (4x less host->device bandwidth than float32; the
        extractor casts on device). Callers with a frame of lookahead should
        upload frame n+1 before tracking frame n so the transfer overlaps
        tracking compute (the device-side replacement for the reference's
        blocking cv::imread in the driver loop)."""
        if isinstance(img, jax.Array):
            return img
        a = np.asarray(img)
        if a.dtype not in (np.uint8, np.float32):
            a = a.astype(np.float32)
        return jax.device_put(a)

    def track(self, img, t, imu=None, depth=None, img_right=None):
        """Process one frame. img: (H,W) float32 or uint8 (host array, or a
        device array staged by `upload`); t: time; imu: (T,7) rows
        [gyro, acc, dt] since the previous frame (VI mode); depth: optional
        (H,W) metric depth map (RGB-D mode, TrackRGBD); img_right: optional
        rectified right image (stereo mode, TrackStereo).

        Hot path (monocular, state OK): ONE fused device dispatch
        (tracking.frame_pipeline_vi / frame_pipeline_visual) and ZERO blocking
        pulls — the previous frame's summary is harvested at the START of the
        next call (by then its async host copy has landed), and keyframe-rate
        work runs there. This is the single-loop shape of the reference's
        tracking thread + LocalMapping/LoopClosing threads
        (src/System.cpp:191-203): tracking never waits for its own scalars,
        and map updates happen between frames at keyframe rate."""
        cfg = self.cfg
        # deferred decisions for in-flight frames (may run KF events /
        # VI init / declare LOST) — BEFORE this frame's IMU is appended, so a
        # keyframe cut at a previous frame gets exactly its own IMU span
        self._harvest_pending()
        if imu is not None and len(imu):
            rows = np.asarray(imu, np.float32)
            self.imu_since_kf.append((self.frame_id, rows))
            self.imu_since_frame.append((self.frame_id, rows))
        depth_mode = depth is not None or img_right is not None
        if self.state == OK and not depth_mode and self.reloc_buf is None:
            # fused async hot path
            with self.timers.stage("track"):
                if self.vi_inited:
                    if self.PAIR > 1:
                        self._pair_push(self.upload(img), t)
                    else:
                        self._dispatch_frame_vi(self.upload(img), t)
                else:
                    self._dispatch_frame_visual(self.upload(img), t)
            self.last_time = t
            self.frame_id += 1
            return True      # optimistic; a lost frame surfaces next call
        # mode transition (init/reloc/depth): drain every in-flight frame
        # before synchronous processing
        self._harvest_pending(drain=True)
        return self._track_sync(img, t, depth, img_right)

    def _track_sync(self, img, t, depth=None, img_right=None):
        """Synchronous per-frame path: initialization, relocalization, the
        post-reloc bias window, and stereo/RGB-D modes (each needs host
        decisions mid-frame; none is frame-rate-critical in steady state)."""
        cfg = self.cfg
        with self.timers.stage("extract"):
            feats = extractor.extract(self.upload(img),
                                      n_features=cfg.n_feat, n_levels=cfg.n_levels)
            uv = self._undistort(feats)
        feat_depth = self._feature_depth(feats, uv, depth, img_right)
        # virtual right-image u coordinate (the reference's mvuRight, mbf/z):
        # the metric-depth residual row for stereo/RGB-D BA
        if feat_depth is not None:
            self.sensor_depth = True
            d = jnp.maximum(feat_depth, 1e-6)
            self._cur_ur = jnp.where(
                feat_depth > 1e-3,
                uv[:, 0] - float(self.cam.fx) * self.cfg.stereo_baseline / d,
                -1.0)
        else:
            self._cur_ur = None
        ok = False
        if self.state == NO_IMAGES_YET:
            if feat_depth is not None:
                ok = self._initialize_from_depth(feats, uv, feat_depth, t)
            else:
                self.init_feats, self.init_uv = feats, uv
                self.state = NOT_INITIALIZED
        elif self.state == NOT_INITIALIZED:
            if feat_depth is not None:
                ok = self._initialize_from_depth(feats, uv, feat_depth, t)
            else:
                ok = self._try_initialize(feats, uv, t)
        else:
            if self.state == LOST:
                # once LOST, go straight to relocalization (Track() does the
                # same, src/Tracking.cpp:886-890) — running IMU/visual tracking
                # from a garbage pose can "accept" on accidental inliers and
                # corrupt the carried biases
                with self.timers.stage("relocalize"):
                    ok = self._relocalize(feats, uv, t)
                    if ok:
                        self._invalidate_frame_caches()
            else:
                with self.timers.stage("track"):
                    ok = self._track_frame(feats, uv, t)
                if not ok and self.state == LOST:
                    with self.timers.stage("relocalize"):
                        ok = self._relocalize(feats, uv, t)
                        if ok:
                            self._invalidate_frame_caches()
            if ok and not self.localization_only and self._need_new_kf():
                with self.timers.stage("local_mapping"):
                    slot = self._create_keyframe(feats, uv, t)
                    if feat_depth is not None:
                        self._add_depth_points(slot, feats, uv, feat_depth)
                    self._local_mapping()
                with self.timers.stage("loop_closing"):
                    self._try_close_loop(slot)
                self._invalidate_frame_caches()
            if ok and not self.vi_inited and cfg.use_imu:
                with self.timers.stage("vi_init"):
                    self._maybe_vi_init(t)
                    if self.vi_inited:
                        self._invalidate_frame_caches()
        self.last_feats = feats
        self.last_time = t
        if self.state == OK:
            self._record_traj_sync(t)
        elif self.state == LOST:
            self.n_lost_frames += 1
        self.frame_id += 1
        return ok

    # ------------------------------------------------------------------
    # Depth modes: RGB-D and stereo (System.h:45-50 sensor enum; stereo
    # matching replaces Frame's L/R threads; StereoInitialization creates the
    # map from the first frame instead of 2-view RANSAC)
    # ------------------------------------------------------------------
    def _feature_depth(self, feats, uv, depth, img_right):
        """Per-feature metric depth from an RGB-D map or a rectified right
        image; None in monocular mode."""
        if depth is not None:
            dm = np.asarray(depth, np.float32)
            xy = np.asarray(feats.xy)
            xs = np.clip(xy[:, 0].astype(int), 0, dm.shape[1] - 1)
            ys = np.clip(xy[:, 1].astype(int), 0, dm.shape[0] - 1)
            d = dm[ys, xs]
            return jnp.asarray(np.where(d > 1e-3, d, -1.0))
        if img_right is not None:
            from mc_slam.frontend import stereo
            fR = extractor.extract(jnp.asarray(img_right, jnp.float32),
                                   n_features=self.cfg.n_feat,
                                   n_levels=self.cfg.n_levels)
            uvR = self._undistort(fR)
            d, ok = stereo.stereo_depth(uv, feats.desc_pm1, feats.valid,
                                        uvR, fR.desc_pm1, fR.valid,
                                        float(self.cam.fx), self.cfg.stereo_baseline)
            # only "close" points are trustworthy stereo depth (the reference's
            # mThDepth = 35 * baseline rule); farther landmarks come from
            # multi-view triangulation instead
            return jnp.where(d < 35.0 * self.cfg.stereo_baseline, d, -1.0)
        return None

    def _depth_to_world(self, uv, feat_depth, P_b, R_b):
        """Ideal pixel + depth -> world points under body pose (P_b, R_b)."""
        xn = (uv - jnp.asarray([float(self.cam.cx), float(self.cam.cy)])) / \
            jnp.asarray([float(self.cam.fx), float(self.cam.fy)])
        Xc = jnp.concatenate([xn * feat_depth[:, None], feat_depth[:, None]], axis=1)
        Rbc = jnp.swapaxes(self.ext.Rcb, -1, -2)
        pbc = -(Rbc @ self.ext.tcb[..., None])[..., 0]
        Xb = (Rbc @ Xc[..., None])[..., 0] + pbc
        return (R_b @ Xb[..., None])[..., 0] + P_b

    def _alloc_points(self, Xw, desc, pm1, level, ref_slot, order_sel,
                      angle=None):
        """Write new landmarks into free map slots. order_sel: bool (F,) mask in
        feature order; returns the chosen slots (np array aligned to features)."""
        m = self.m
        free_slots = np.nonzero(~np.asarray(m.mp_active))[0]
        feat_idx = np.nonzero(order_sel)[0]
        k = min(len(free_slots), len(feat_idx))
        feat_idx = feat_idx[:k]
        slots = free_slots[:k]
        if k == 0:
            return np.zeros(0, int), np.zeros(0, int)
        Xs = np.asarray(Xw)[feat_idx]
        dist = np.linalg.norm(Xs - np.asarray(self.m.kf_ns.P[ref_slot]), axis=1)
        lvl = np.asarray(level)[feat_idx].astype(np.float32)
        max_d = dist * (1.2 ** lvl)
        min_d = np.asarray(mapping.band_min_dist(max_d, self.cfg.n_levels))
        sl = jnp.asarray(slots)
        self.m = m._replace(
            mp_pos=m.mp_pos.at[sl].set(jnp.asarray(Xs)),
            mp_desc=m.mp_desc.at[sl].set(desc[jnp.asarray(feat_idx)]),
            mp_pm1=m.mp_pm1.at[sl].set(pm1[jnp.asarray(feat_idx)]),
            mp_normal=m.mp_normal.at[sl].set(
                jnp.asarray(Xs / np.maximum(dist, 1e-9)[:, None])),
            mp_min_dist=m.mp_min_dist.at[sl].set(jnp.asarray(min_d)),
            mp_max_dist=m.mp_max_dist.at[sl].set(jnp.asarray(max_d)),
            mp_ref_kf=m.mp_ref_kf.at[sl].set(ref_slot),
            mp_angle=(m.mp_angle.at[sl].set(angle[jnp.asarray(feat_idx)])
                      if angle is not None else m.mp_angle),
            mp_first_kf=m.mp_first_kf.at[sl].set(self.frame_id),
            mp_found=m.mp_found.at[sl].set(1.0),
            mp_visible=m.mp_visible.at[sl].set(1.0),
            mp_active=m.mp_active.at[sl].set(True),
            kf_mp=m.kf_mp.at[ref_slot, jnp.asarray(feat_idx)].set(sl),
        )
        return feat_idx, slots

    def _initialize_from_depth(self, feats, uv, feat_depth, t):
        """Stereo/RGB-D initialization: one keyframe, metric points from depth
        (Tracking::StereoInitialization)."""
        good = np.asarray(feats.valid) & (np.asarray(feat_depth) > 1e-3)
        if good.sum() < 50:
            return False
        slot = self._insert_kf_raw(jnp.zeros(3), jnp.eye(3), feats, uv, t_kf=t)
        Xw = self._depth_to_world(uv, feat_depth, jnp.zeros(3), jnp.eye(3))
        self._alloc_points(Xw, feats.desc, feats.desc_pm1, feats.level, slot,
                           good, angle=feats.angle)
        self.last_pose = (jnp.zeros(3), jnp.eye(3))
        self.velocity = (jnp.zeros(3), jnp.eye(3))
        self.state = OK
        self._cur_feat_mp = jnp.asarray(np.asarray(self.m.kf_mp[slot]))
        self._cur_inliers = int(good.sum())
        return True

    def _add_depth_points(self, slot, feats, uv, feat_depth, max_new=128):
        """On keyframe creation, add landmarks for unassociated features with
        depth (Tracking::CreateNewKeyFrame's close-point insertion for
        stereo/RGB-D)."""
        has_mp = np.asarray(self.m.kf_mp[slot]) >= 0
        d_np = np.asarray(feat_depth)
        cand = np.asarray(feats.valid) & (d_np > 1e-3) & ~has_mp
        if cand.sum() == 0:
            return
        # nearest-first, capped
        order = np.argsort(np.where(cand, d_np, np.inf))[:max_new]
        sel = np.zeros_like(cand)
        sel[order[np.isfinite(np.where(cand, d_np, np.inf)[order])]] = True
        P_b, R_b = self._kf_body_pose(slot)
        Xw = self._depth_to_world(uv, feat_depth, P_b, R_b)
        self._alloc_points(Xw, feats.desc, feats.desc_pm1, feats.level, slot, sel,
                           angle=feats.angle)

    # ------------------------------------------------------------------
    # Monocular initialization (Tracking::MonocularInitialization :1322)
    # ------------------------------------------------------------------
    def _try_initialize(self, feats, uv, t):
        cfg = self.cfg
        f0, uv0 = self.init_feats, self.init_uv
        idx, best, ok = matching.search_for_initialization(
            uv0, f0.desc_pm1, f0.valid, uv, feats.desc_pm1, feats.valid,
            radius=100.0, ratio=0.9, f0_angle=f0.angle, f1_angle=feats.angle)
        n = int(jnp.sum(ok))
        if n < cfg.min_init_matches:
            # too few matches: make this the new reference (reference resets too)
            self.init_feats, self.init_uv = feats, uv
            return False
        focal = float(self.cam.fx)
        xn0 = (uv0 - jnp.asarray([self.cam.cx, self.cam.cy])) / jnp.asarray(
            [self.cam.fx, self.cam.fy])
        xn1_all = (uv - jnp.asarray([self.cam.cx, self.cam.cy])) / jnp.asarray(
            [self.cam.fx, self.cam.fy])
        xn1 = xn1_all[idx]
        self.key, sub = jax.random.split(self.key)
        res = init2view.initialize_two_view(sub, xn0, xn1,
                                            ok.astype(jnp.float32), focal)
        if not bool(res.ok):
            return False
        # scale: median depth of good points -> 1 (CreateInitialMapMonocular)
        good = np.asarray(res.good)
        Xw = np.asarray(res.Xw)
        med = float(np.median(Xw[good][:, 2])) if good.sum() else 1.0
        if med <= 1e-6:
            return False
        scale = 1.0 / med
        Xw = Xw * scale
        C1 = np.asarray(res.t) * scale

        # KF0 at camera origin, KF1 at (R,C1) — body == camera during visual init;
        # we store body poses assuming ext maps body->cam (apply inverse ext)
        self._insert_kf_raw(jnp.zeros(3), jnp.eye(3), f0, uv0, t_kf=self.last_time,
                            cam_frame=True)
        slot1 = self._insert_kf_raw(jnp.asarray(C1), jnp.asarray(res.R), feats, uv,
                                    t_kf=t, cam_frame=True)
        # allocate map points and associations
        good_idx = np.nonzero(good)[0]
        m = self.m
        slots = np.arange(len(good_idx), dtype=np.int32)
        mp_pos = m.mp_pos.at[slots].set(jnp.asarray(Xw[good_idx]))
        desc = f0.desc[good_idx]
        pm1 = f0.desc_pm1[good_idx]
        cwa = np.zeros(3, np.float32)
        dist_a = np.linalg.norm(Xw[good_idx] - cwa, axis=1).astype(np.float32)
        lvl = np.asarray(f0.level)[good_idx].astype(np.float32)
        max_d = dist_a * (1.2 ** lvl)
        min_d = np.asarray(mapping.band_min_dist(max_d, self.cfg.n_levels))
        m = m._replace(
            mp_pos=mp_pos,
            mp_desc=m.mp_desc.at[slots].set(desc),
            mp_pm1=m.mp_pm1.at[slots].set(pm1),
            mp_normal=m.mp_normal.at[slots].set(
                jnp.asarray(Xw[good_idx] / np.maximum(dist_a, 1e-9)[:, None])),
            mp_min_dist=m.mp_min_dist.at[slots].set(jnp.asarray(min_d)),
            mp_max_dist=m.mp_max_dist.at[slots].set(jnp.asarray(max_d)),
            mp_ref_kf=m.mp_ref_kf.at[slots].set(0),
            mp_angle=m.mp_angle.at[slots].set(f0.angle[good_idx]),
            mp_first_kf=m.mp_first_kf.at[slots].set(0),
            mp_found=m.mp_found.at[slots].set(2.0),
            mp_visible=m.mp_visible.at[slots].set(2.0),
            mp_active=m.mp_active.at[slots].set(True),
            kf_mp=m.kf_mp
                .at[0, jnp.asarray(good_idx)].set(jnp.asarray(slots))
                .at[slot1, jnp.asarray(np.asarray(idx)[good_idx])].set(jnp.asarray(slots)),
        )
        self.m = m
        # initial visual BA over the two views (GlobalBundleAdjustment(20))
        self._local_ba(force_all=True)
        self.last_pose = self._kf_body_pose(slot1)
        self.velocity = (jnp.zeros(3), jnp.eye(3))
        self.state = OK
        return True

    def _kf_body_pose(self, slot):
        return self.m.kf_ns.P[slot], self.m.kf_ns.R[slot]

    def _cam_to_body(self, P_c, R_c):
        """Camera pose (world-from-camera) -> body pose via extrinsics."""
        Rbc = jnp.swapaxes(self.ext.Rcb, -1, -2)
        pbc = -(Rbc @ self.ext.tcb[..., None])[..., 0]
        R_b = R_c @ jnp.swapaxes(Rbc, -1, -2)
        P_b = P_c - (R_b @ pbc[..., None])[..., 0]
        return P_b, R_b

    def _alloc_kf_slot(self):
        """Slot allocation with recycling (VERDICT round-1 item 9): culled
        slots are reused; at hard capacity the most redundant old active KF is
        evicted (the reference's map is unbounded, src/KeyFrame.cpp; a fixed
        padded table needs an eviction policy instead of an assert)."""
        if self.free_slots:
            return self.free_slots.pop(0)
        if self.next_fresh_slot < self.cfg.max_kf:
            slot = self.next_fresh_slot
            self.next_fresh_slot += 1
            return slot
        # capacity exhausted: evict — prefer the most redundant old KF,
        # protecting KF0 (gauge), the recent local window, and loop-edge
        # carriers (KeyFrame::SetNotErase for loop KFs)
        prot = set(self.kf_slots[-max(2, self.cfg.local_window):]) | {self.kf_slots[0]}
        for e in self.loop_edges:
            prot.add(e[0]); prot.add(e[1])
        cand = [s2 for s2 in self.kf_slots if s2 not in prot]
        if not cand:
            cand = [self.kf_slots[1]]
        red = []
        for s2 in cand[:16]:
            ratio, n_pts = mapping.kf_redundancy(self.m, jnp.asarray(s2))
            red.append((float(ratio), s2))
        victim = max(red)[1]
        self._remove_keyframe(victim)
        return self.free_slots.pop(0)

    def _remove_keyframe(self, s2):
        """Deactivate a KF and recycle its slot (SetBadFlag bookkeeping)."""
        self._splice_imu_chain(s2)
        # re-anchor map points referencing the removed KF to its successor
        act = self.kf_slots
        i = act.index(s2)
        heir = act[i + 1] if i + 1 < len(act) else act[i - 1]
        # reparent trajectory entries referencing this KF onto the heir
        # (KeyFrame::SetBadFlag parenting: saved frame poses compose through
        # the surviving parent, src/KeyFrame.cpp:195-252) — otherwise those
        # frames fall back to their track-time absolute pose and miss every
        # later correction (VI-init rescale, loop closures, GBA)
        kid = self.kf_id_host[s2]
        heir_id = self.kf_id_host[heir]
        Pk = np.asarray(self.m.kf_ns.P[s2])
        Rk = np.asarray(self.m.kf_ns.R[s2])
        Ph = np.asarray(self.m.kf_ns.P[heir])
        Rh = np.asarray(self.m.kf_ns.R[heir])
        R_hk = Rh.T @ Rk                     # culled KF in heir frame
        P_hk = Rh.T @ (Pk - Ph)
        self.traj.reparent(s2, kid, heir, heir_id, P_hk, R_hk)
        ref = self.m.mp_ref_kf
        self.m = self.m._replace(
            mp_ref_kf=jnp.where(ref == s2, heir, ref))
        self.m = mapping.deactivate_keyframe(self.m, jnp.asarray(s2))
        self.kf_slots.remove(s2)
        self.loop_edges = [e for e in self.loop_edges
                           if e[0] != s2 and e[1] != s2]
        self.kf_imu_raw.pop(s2, None)
        self.kf_time_host.pop(s2, None)
        self.kf_id_host.pop(s2, None)
        self.broken_chain_slots.discard(s2)
        self.free_slots.append(s2)

    def _insert_kf_raw(self, P_pose, R_pose, feats, uv, t_kf, cam_frame=False,
                       fid=None, ns=None, feat_mp=None):
        """Write a keyframe into a free slot (one fused device program,
        mapping.write_keyframe). Returns slot index."""
        fid = self.frame_id if fid is None else fid
        src_ns = ns if ns is not None else self.last_ns
        if cam_frame:
            P_pose, R_pose = self._cam_to_body(P_pose, R_pose)
        slot = self._alloc_kf_slot()
        pre = None
        take = [r for f, r in self.imu_since_kf if f <= fid]
        if self.cfg.use_imu and take:
            raw = np.concatenate(take, 0)
            self.kf_imu_raw[slot] = raw
            # device handles, no pull: bias of the state carried into this KF
            bg = (src_ns.bg_full if self.vi_inited
                  else jnp.zeros(3, jnp.float32))
            ba_ = (src_ns.ba_full if self.vi_inited
                   else jnp.zeros(3, jnp.float32))
            pre = self._preintegrate_raw(raw, bg, ba_)
            self.imu_since_kf = [(f, r) for f, r in self.imu_since_kf
                                 if f > fid]
        # fold delta-bias into the base bias at KF creation
        # (Frame::SetInitialNavStateAndBias, src/Frame.cpp:111-118)
        ur = (self._cur_ur if getattr(self, "_cur_ur", None) is not None
              else jnp.full(self.m.F, -1.0))
        self.m = mapping.write_keyframe(
            self.m, jnp.asarray(slot, jnp.int32), P_pose, R_pose, src_ns.V,
            src_ns.bg_full, src_ns.ba_full,
            jnp.asarray(t_kf, jnp.float32), jnp.asarray(fid, jnp.int32),
            uv, feats.level, feats.angle, ur, feats.desc, feats.desc_pm1,
            feats.valid, feat_mp=feat_mp, pre=pre)
        self.n_kf += 1
        self.kf_time_host[slot] = float(t_kf)
        self.kf_id_host[slot] = int(fid)
        if self._chain_break_pending:
            self.broken_chain_slots.add(slot)
            self._chain_break_pending = False
        self.kf_slots.append(slot)
        self.last_kf_slot = slot
        self.last_kf_frame = fid
        if self.first_kf_time is None:
            self.first_kf_time = t_kf
        self.loop.add_keyframe(slot, feats.desc_pm1,
                               feats.valid.astype(jnp.float32), kf_id=fid)
        return slot

    # ------------------------------------------------------------------
    def set_localization_mode(self, on: bool):
        """Activate/DeactivateLocalizationMode (include/System.h:83-87): track
        against the frozen map without inserting keyframes or mapping."""
        self.localization_only = bool(on)

    def reset(self):
        """System::Reset semantics: clear the map and start over
        (src/Tracking.cpp:2569)."""
        self.__init__(self.cam, self.cfg, Tbc=self._Tbc, noise=self.noise)

    def global_refine(self):
        """One full-map bundle adjustment over all active keyframes
        (GlobalBundleAdjustment(NavStatePRV), src/Optimizer.cpp:629/3346 — the
        reference runs it after loop closures; offline drivers may also call
        it once at sequence end before saving the trajectory)."""
        self._harvest_pending(drain=True)
        self._local_ba(force_all=True, prune=False)
        self._invalidate_frame_caches()

    def get_trajectory(self):
        """[(t, P_wb (3,), R_wb (3,3))] per tracked frame, composed against the
        CURRENT keyframe poses (System::SaveTrajectoryTUM semantics): frames
        recorded before VI init / loop closures / GBA inherit those
        corrections through their reference keyframe. Frames whose reference
        keyframe was culled (or its slot recycled) keep their track-time pose."""
        self.flush()
        kf_P = np.asarray(self.m.kf_ns.P)
        kf_R = np.asarray(self.m.kf_ns.R)
        kf_id = np.asarray(self.m.kf_id)
        kf_act = np.asarray(self.m.kf_active)
        return self.traj.compose(kf_P, kf_R, kf_id, kf_act)
