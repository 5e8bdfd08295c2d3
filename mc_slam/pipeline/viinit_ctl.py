"""VI-initialization orchestration (SlamSystem mixin): TryInitVIO
acceptance gating + map rescale application (LocalMapping.cpp:200-893
role). Split from system.py (r4 verdict item 9) - no behavior change.
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


class VIInitMixin:
    # ------------------------------------------------------------------
    # VI initialization (LocalMapping::TryInitVIO, src/LocalMapping.cpp:200-893)
    # ------------------------------------------------------------------
    def _maybe_vi_init(self, t):
        cfg = self.cfg
        if self.first_kf_time is None or t - self.first_kf_time < cfg.vi_init_time:
            return
        act = list(self.kf_slots)
        if len(act) < 8:
            return
        # only attempt once per new keyframe (the reference polls, but each
        # attempt re-runs the same data until the map grows)
        if getattr(self, "_last_init_attempt_nkf", -1) == self.n_kf:
            return
        self._last_init_attempt_nkf = self.n_kf
        # clean the visual map first (TryInitVIO runs a visual-only GBA at
        # src/LocalMapping.cpp:240 before the linear solves)
        with self.timers.stage("viinit_gba_vis"):
            self._local_ba(force_all=True)
        # pad the keyframe window to a 16-bucket so the init solve compiles a
        # handful of shapes instead of one per keyframe count (the solvers are
        # mask-aware: padded rows carry valid=0)
        n_real = len(act)
        pad_n = int(np.ceil(n_real / 16)) * 16
        act_p = act + [act[-1]] * (pad_n - n_real)
        ks = jnp.asarray(act_p, jnp.int32)
        # camera poses from body poses (body==camera pre-init)
        Rwb = self.m.kf_ns.R[ks]
        Pwb = self.m.kf_ns.P[ks]
        Rbc = jnp.swapaxes(self.ext.Rcb, -1, -2)
        pbc = -(Rbc @ self.ext.tcb[..., None])[..., 0]
        Rwc = Rwb @ Rbc
        Pwc = Pwb + (Rwb @ pbc[..., None])[..., 0]
        pre = jax.tree_util.tree_map(lambda a: a[ks], self.m.kf_preint)
        valid = jnp.asarray([0.0] + [1.0] * (n_real - 1)
                            + [0.0] * (pad_n - n_real), jnp.float32)
        import time as _time
        _t0 = _time.perf_counter()
        with self.timers.stage("viinit_solve"):
            res = viinit.try_init_vio(Pwc, Rwc, pre, valid, self.ext.Rcb,
                                      self.ext.tcb, g_mag=cfg.g_mag)
            res = jax.tree_util.tree_map(np.asarray, res)
        if self.viinit_log is not None:
            self.viinit_log.log_attempt(t, res,
                                        (_time.perf_counter() - _t0) * 1e3)
        s = float(res.scale)
        if not np.isfinite(s) or s <= 1e-3:
            return
        # acceptance gating beyond the 15 s rule: the step-3 system must be
        # well-conditioned and its scale must agree with the step-2 estimate —
        # a disagreement means the trajectory has not excited scale/gravity
        # yet and the init would seed a wrong-metric map (VI-ORB IV-C
        # diagnostics; reference surfaces them in plotinit)
        sv = np.asarray(res.cond)
        cond = float(sv[0] / max(float(sv[-1]), 1e-12))
        s_star = float(res.scale_star)
        if cond > cfg.vi_init_max_cond:
            return
        if abs(s - s_star) > cfg.vi_init_scale_tol * max(s, 1e-6):
            return
        # re-preintegrate all KFs with the estimated gyro bias
        bg = np.asarray(res.bg)
        ba_np = np.asarray(res.ba)
        with self.timers.stage("viinit_repreint"):
            for slot in act:
                raw = self.kf_imu_raw.get(slot)
                if raw is None:
                    continue
                pre1 = self._preintegrate_raw(raw, jnp.asarray(bg, jnp.float32),
                                              jnp.asarray(ba_np, jnp.float32))
                self.m = self.m._replace(kf_preint=jax.tree_util.tree_map(
                    lambda a, b: a.at[slot].set(b), self.m.kf_preint, pre1))
        pre2 = jax.tree_util.tree_map(lambda a: a[ks], self.m.kf_preint)
        V = viinit.compute_velocities(Pwc, Rwc, pre2, valid, self.ext.Rcb,
                                      self.ext.tcb, jnp.asarray(s), res.gw,
                                      jnp.asarray(ba_np))
        P_b, R_b, V = viinit.apply_init_to_navstates(
            Pwc, Rwc, self.ext.Rcb, self.ext.tcb, jnp.asarray(s),
            res.bg, res.ba, V)
        # padded rows scatter onto the same slot as the last real row — they
        # must carry its values, not pad garbage (shape-stable gather: the
        # clamp index is data, so no per-count recompile)
        row = jnp.minimum(jnp.arange(pad_n), jnp.asarray(n_real - 1))
        P_b, R_b, V = P_b[row], R_b[row], V[row]
        ns = self.m.kf_ns
        z3 = jnp.zeros_like(V)
        ns = ns._replace(
            P=ns.P.at[ks].set(P_b), R=ns.R.at[ks].set(R_b), V=ns.V.at[ks].set(V),
            bg=ns.bg.at[ks].set(jnp.asarray(bg)), ba=ns.ba.at[ks].set(jnp.asarray(ba_np)),
            dbg=ns.dbg.at[ks].set(z3), dba=ns.dba.at[ks].set(z3))
        # scale map points
        self.m = self.m._replace(
            kf_ns=ns, mp_pos=self.m.mp_pos * s,
            mp_min_dist=self.m.mp_min_dist * s, mp_max_dist=self.m.mp_max_dist * s)
        # rescale the recorded per-frame trajectory to the new metric unit
        # (Map::UpdateScale analog for the saved-frame list): P_rel offsets
        # were captured in the pre-init visual scale — composing them
        # unscaled against the rescaled keyframe poses leaves every pre-init
        # frame ~s x off and dominates full-run ATE
        self.traj.rescale(s)
        self.gw = res.gw
        self.vi_inited = True
        self.events.append((self.frame_id, "vi_init",
                            dict(scale=round(s, 4), n_kf=len(act))))
        self.last_ns = jax.tree_util.tree_map(lambda a: a[act[-1]], ns)
        self.last_pose = (self.last_ns.P, self.last_ns.R)
        # the next VI-tracked frame integrates from the newest keyframe
        self.imu_since_frame = list(self.imu_since_kf)
        self.prior = None
        # full VI global BA (GlobalBundleAdjustmentNavStatePRV)
        with self.timers.stage("viinit_gba_vi"):
            self._local_ba(force_all=True)
        self.last_ns = jax.tree_util.tree_map(lambda a: a[act[-1]], self.m.kf_ns)
        self.last_pose = (self.last_ns.P, self.last_ns.R)

