"""Loop detection and correction.

Replaces LoopClosing (src/LoopClosing.cpp): BoW candidate retrieval gated by the
covisibility minimum score (:143-158), temporal consistency (:174-269 — here a
simple consecutive-detection counter), Sim3 solve between matched map points
(:277-498), loop correction: Sim3 propagation of keyframes, map-point remap,
fusion, essential-graph optimization (:501-728), and full global BA.

The stage functions are jitted; the orchestration entry `detect_and_close` is
host-side and mutates the SlamSystem's MapState exactly once per accepted loop
(epoch-style, replacing the reference's stop-LocalMapping/abort-GBA dance).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.frontend import bow, matching
from mc_slam.geometry import sim3solver
from mc_slam.slam_map.mapstate import (MapState, covisibility_matrix,
                                           covisibility_weights)
from mc_slam.solver import posegraph


@jax.jit
def _detect_device(m: MapState, hists, slot):
    """Device half of loop detection: BoW scores of every KF against `slot`
    plus the full covisibility matrix — ONE dispatch whose result the host can
    harvest later (a per-event blocking pull would be a device round trip)."""
    q = hists[slot]
    scores = hists @ q
    W = covisibility_matrix(m)
    return scores, W


class LoopDetector:
    """Detector state: per-KF BoW histograms (device-resident — a host pull
    per keyframe blocked the event loop) + host consistency counters."""

    def __init__(self, vocab, max_kf, min_consistency=3, idf=None):
        self.vocab = vocab
        self.idf = idf
        self.hists = jnp.zeros((max_kf, vocab.shape[0]), jnp.float32)
        jax.block_until_ready(self.hists)   # see bow.load_default_vocab
        self.min_consistency = min_consistency
        # [(covisibility group frozenset, consistency count)] carried between
        # keyframes (mvConsistentGroups, src/LoopClosing.cpp:174-269)
        self.consistent_groups: list[tuple[frozenset, int]] = []
        # slot -> kf id of the histogram occupant (host mirror): detection is
        # deferred (dispatch -> harvest frames later), and a slot recycled in
        # between still carries the evicted KF's histogram — its score must
        # not be attributed to the new occupant (ADVICE r4)
        self.hist_ids: dict[int, int] = {}
        self._dispatch_ids: dict[int, int] | None = None

    def add_keyframe(self, slot, desc_pm1, valid, kf_id=None):
        h = bow.bow_histogram(desc_pm1, valid, self.vocab, idf=self.idf)
        self.hists = self.hists.at[slot].set(h)
        if kf_id is not None:
            self.hist_ids[int(slot)] = int(kf_id)

    def detect_dispatch(self, m: MapState, slot):
        """Dispatch the device half; returns handles to harvest later. At most
        one detect is in flight (the caller force-drains the previous event
        before dispatching), so the dispatch-time slot->id snapshot lives on
        the detector."""
        self._dispatch_ids = dict(self.hist_ids)
        return _detect_device(m, self.hists, jnp.asarray(slot, jnp.int32))

    def detect(self, m: MapState, slot, kf_slots, kf_ids=None, min_gap=10,
               handles=None):
        """Returns loop candidate slots, best score first (possibly empty).

        Mirrors DetectLoop (src/LoopClosing.cpp:143-269): candidates must score
        above the minimum covisible score and be temporally distant; each
        candidate's covisibility GROUP carries an independent consistency
        counter across consecutive keyframes — a single best-candidate counter
        is fragile when place-recognition scores are flat, since unrelated
        false candidates reset the streak of the true one.

        kf_ids: host {slot: creation frame id} (avoids a device pull);
        handles: optional (scores, W) handles from detect_dispatch."""
        if handles is None:
            handles = self.detect_dispatch(m, slot)
        scores, W = map(np.asarray, handles)
        # the covisibility matrix rides along with detection: candidate
        # GROUP construction (consistency streaks here, the guided-
        # verification groups in the caller) must not cost per-candidate
        # device pulls
        self.last_W = W
        covis = W[slot].copy()
        covis[slot] = 0
        # min score among covisible keyframes (reference minScore)
        cov_slots = [k for k in np.nonzero(covis >= 15)[0] if k != slot]
        min_score = min((float(scores[k]) for k in cov_slots), default=0.3)
        if kf_ids is None:
            ids = np.asarray(m.kf_id)
            kf_ids = {k: int(ids[k]) for k in kf_slots}
        # exclusion mirrors the reference's connected-set test
        # (GetConnectedKeyFrames, weight >= 15 per UpdateConnections): a
        # weight-1 accidental fuse association must not veto a true revisit
        # drop slots whose histogram occupant changed between dispatch and
        # harvest (recycled slot: the score belongs to the evicted KF)
        snap = self._dispatch_ids

        def fresh(k):
            cur = self.hist_ids.get(k)
            if snap is None or cur is None:
                return True      # no registration info for this slot
            return snap.get(k) == cur
        # absolute floor 0.15: the held-out study (artifacts/vocab_eval.json)
        # puts true-revisit top scores at median 0.36-0.40 with the idf
        # vocabulary while sub-0.15 scores are overwhelmingly noise — the old
        # 0.05 floor proposed Sim3 candidates at nearly every keyframe event
        # (90 batches / 107 events on the r4 flagship run, all false)
        cands = [k for k in kf_slots
                 if k != slot and covis[k] < 15
                 and abs(kf_ids[slot] - kf_ids[k]) >= min_gap
                 and scores[k] >= max(min_score, 0.15) and fresh(k)]
        # diagnostics for the caller's event log: why candidates did (not)
        # survive the score bar
        non_cov = [float(scores[k]) for k in kf_slots
                   if k != slot and covis[k] < 15
                   and abs(kf_ids[slot] - kf_ids[k]) >= min_gap]
        self.last_diag = dict(min_score=round(float(min_score), 3),
                              best_noncovis=round(max(non_cov, default=-1.0),
                                                  3),
                              n_cands=len(cands))
        if not cands:
            self.consistent_groups = []
            return []
        new_groups: list[tuple[frozenset, int]] = []
        enough: list[tuple[float, int]] = []
        rest: list[tuple[float, int]] = []
        for k in cands:
            group = frozenset({k} | {int(x) for x in np.nonzero(W[k] >= 15)[0]})
            streak = 0
            for pg, pc in self.consistent_groups:
                if pg & group:
                    streak = max(streak, pc + 1)
            new_groups.append((group, streak))
            if streak + 1 >= self.min_consistency:
                enough.append((float(scores[k]), k))
            else:
                rest.append((float(scores[k]), k))
        self.consistent_groups = new_groups
        enough.sort(reverse=True)
        rest.sort(reverse=True)
        # streak-qualified candidates first, then the best-scoring others.
        # The streak (reference's 3-consecutive-consistent-groups rule,
        # src/LoopClosing.cpp:174-269) is the temporal filter against
        # repetitive-scene false positives; non-streak candidates are still
        # returned (our Sim3 RANSAC is one batched device call) but flagged
        # so the caller can demand a much higher geometric-consensus bar
        # (the reference's guided-match total, LoopClosing.cpp:459-498).
        return ([(k, True) for _, k in enough]
                + [(k, False) for _, k in rest[:3]])


def compute_sim3_for_loop(m: MapState, key, slot_cur, slot_loop, cam,
                          min_inliers=20, fix_scale=False, ext=None):
    """Match map points between the two keyframes' observations, solve Sim3
    (ComputeSim3, src/LoopClosing.cpp:277-498). Returns (ok, s, R, t) with
    (s,R,t) mapping loop-KF camera coords -> current-KF camera coords.

    fix_scale=True constrains the solve to SE3 (s=1) — REQUIRED in VI mode,
    where scale is observable (the reference's bFixScale, LoopClosing.cpp:73
    Sim3Solver ctor arg): a free-scale RANSAC estimate is biased by depth
    noise, and feeding s!=1 loop edges into a scale-fixed pose graph makes
    every closure contract or inflate the map (observed: ate_scale 0.72
    after 18 closures on the euroc clone)."""
    # features with associated map points in each KF
    mp_c = m.kf_mp[slot_cur]
    mp_l = m.kf_mp[slot_loop]
    has_c = (mp_c >= 0) & m.kf_feat_valid[slot_cur]
    has_l = (mp_l >= 0) & m.kf_feat_valid[slot_loop]
    idx, best, ok = matching.mutual_match(
        m.kf_pm1[slot_cur], has_c, m.kf_pm1[slot_loop], has_l,
        max_dist=matching.TH_LOW, ratio=0.9,
        angle_a=m.kf_angle[slot_cur], angle_b=m.kf_angle[slot_loop])
    # 3D positions in each keyframe's CAMERA frame (ext=None: body==camera)
    def cam_coords(slot, mp):
        Rwb = m.kf_ns.R[slot]
        Pwb = m.kf_ns.P[slot]
        X = m.mp_pos[jnp.clip(mp, 0, m.P - 1)]
        Xb = (jnp.swapaxes(Rwb, -1, -2) @ (X - Pwb)[..., None])[..., 0]
        if ext is None:
            return Xb
        return (ext.Rcb @ Xb[..., None])[..., 0] + ext.tcb
    Pc_cur = cam_coords(slot_cur, mp_c)
    Pc_loop = cam_coords(slot_loop, mp_l[idx])
    w = ok.astype(jnp.float32)
    res = sim3solver.sim3_ransac(key, Pc_loop, Pc_cur, w, float(cam.fx),
                                 min_inliers=min_inliers, fix_scale=fix_scale)
    if not bool(res.ok):
        return res
    # pixel-space refinement on the RANSAC inliers (Optimizer::OptimizeSim3,
    # called from ComputeSim3 at src/LoopClosing.cpp:361)
    from mc_slam.solver.sim3opt import optimize_sim3
    uv_cur = m.kf_uv[slot_cur]
    uv_loop = m.kf_uv[slot_loop][idx]
    w_in = res.inliers.astype(jnp.float32) * w
    s2, R2, t2, n_in = optimize_sim3(res.s, res.R, res.t, Pc_cur, Pc_loop,
                                     uv_cur, uv_loop, w_in, cam, iters=10,
                                     fix_scale=fix_scale)
    # keep the refinement only when it strictly improves inlier support —
    # otherwise trust the RANSAC-consensus estimate
    if int(n_in) > int(res.n_inliers):
        res = res._replace(s=s2, R=R2, t=t2, n_inliers=n_in)
    return res


def close_loop(m: MapState, kf_slots, slot_cur, slot_loop, sim3_lc, cam,
               fix_scale=False, loop_edges=None, mesh=None):
    """Apply the loop correction: build the Sim3 ESSENTIAL graph over active
    KFs — sequential chain (spanning tree), ALL covisibility pairs with
    weight >= 100 across the map, the current KF's >= 50 links, every
    PERSISTED past loop edge, and the new loop edge — optimize, correct map
    points with their reference KFs. Returns the new MapState.

    sim3_lc: Sim3Result mapping loop-KF cam frame -> current-KF cam frame.
    loop_edges: [(slot_a, slot_b)] previously accepted closures; the
    reference stores each closure permanently on both keyframes
    (LoopClosing.cpp:710-711, KeyFrame.cpp:836-847) and re-includes them in
    every OptimizeEssentialGraph (Optimizer.cpp:4413-4420) — without them,
    closure #N re-opens the seams healed by closures #1..N-1.
    """
    slots = [s for s in kf_slots]
    K = len(slots)
    idx_of = {s: i for i, s in enumerate(slots)}
    dtype = m.mp_pos.dtype
    # bucket-pad vertices/edges so each loop closure doesn't compile a fresh
    # pose-graph program (device compiles are expensive); pad vertices
    # duplicate the last slot with free=0 and no edges
    Kp = max(32, int(np.ceil(K / 32)) * 32)
    slots_p = slots + [slots[-1]] * (Kp - K)

    # vertices: world->kf (Scw), from current body poses (s=1)
    Rwk = m.kf_ns.R[jnp.asarray(slots_p)]
    Pwk = m.kf_ns.P[jnp.asarray(slots_p)]
    R0 = jnp.swapaxes(Rwk, -1, -2)
    t0 = -(R0 @ Pwk[..., None])[..., 0]
    s0 = jnp.ones(Kp, dtype)

    # edges: sequential chain (spanning tree), then the full essential graph
    ei, ej, ew = [], [], []
    seen = {}

    def add_edge(a, b, w=1.0):
        key = (min(a, b), max(a, b))
        if a == b:
            return
        if key in seen:
            # duplicate pair: keep the single edge, upgraded to the max
            # weight (a healed-seam pair that is also covisibility-connected
            # must stay a strong edge, never a double one)
            i = seen[key]
            ew[i] = max(ew[i], w)
            return
        seen[key] = len(ei)
        ei.append(a); ej.append(b); ew.append(w)

    for a, b in zip(range(K - 1), range(1, K)):
        add_edge(a, b)
    # all strong covisibility pairs across the map (>= 100 shared points, the
    # reference's essential-graph threshold, Optimizer.cpp:4468-4499) — one
    # batched K x K device pass; a chain + current-KF star distributes loop
    # error along the single temporal path and over-rotates side branches
    from mc_slam.slam_map.mapstate import covisibility_matrix
    W = np.asarray(covisibility_matrix(m))
    for a, b in zip(*np.nonzero(np.triu(W, 1) >= 100)):
        if int(a) in idx_of and int(b) in idx_of:
            add_edge(idx_of[int(a)], idx_of[int(b)])
    # current KF's >= 50 links (denser around the active seam)
    for k in np.nonzero(W[slot_cur] >= 50)[0]:
        if int(k) in idx_of:
            add_edge(idx_of[int(k)], idx_of[slot_cur])
    # persisted loop edges from past closures. Their measurement is the
    # CURRENT relative Sim3, like every other edge — the reference never
    # stores measurements (OptimizeEssentialGraph recomputes Sji from current
    # estimates for spanning/covisibility/loop edges alike,
    # src/Optimizer.cpp:4413-4499): window BA and GBA keep refining the pair
    # after a closure, and a frozen closure-time measurement at high weight
    # would drag the neighborhood back to stale geometry at the NEXT closure
    # (observed: a mid-run map warp + relocalization storm). The persistence
    # is topological — the strong edge keeps later optimizations from
    # re-distributing their corrections across an already-healed seam.
    # routed through add_edge's `seen` dedup (ADVICE r4): a re-closure of the
    # same pair after the cooldown must not accumulate duplicate 5.0-weight
    # edges and progressively over-stiffen that seam
    for e in (loop_edges or []):
        a, b = e[0], e[1]
        if a in idx_of and b in idx_of and a != b:
            add_edge(idx_of[a], idx_of[b], w=5.0)
    i_loop, i_cur = idx_of[slot_loop], idx_of[slot_cur]
    n_edges = len(ei)
    Ep = max(64, int(np.ceil((n_edges + 1) / 32)) * 32)
    w_np = np.zeros(Ep, np.float32)
    w_np[:n_edges] = ew
    w_np[n_edges] = 5.0                                  # strong loop edge
    ei = ei + [0] * (Ep - n_edges)
    ej = ej + [0] * (Ep - n_edges)

    ei_a = jnp.asarray(ei, jnp.int32)
    ej_a = jnp.asarray(ej, jnp.int32)
    # edge measurements from the UNCORRECTED estimates (the reference's
    # NonCorrectedSim3, src/LoopClosing.cpp:559-639 + Optimizer.cpp:4413)
    sm, Rm, tm = posegraph.edge_measurement(
        s0[ei_a], R0[ei_a], t0[ei_a], s0[ej_a], R0[ej_a], t0[ej_a])

    # the loop edge (i=loop, j=cur) at position n_edges: measurement
    # S_{cur,loop} — exactly the RANSAC Sim3, which maps loop-KF camera
    # coords into current-KF camera coords
    li = jnp.asarray(n_edges)
    ei_a = ei_a.at[li].set(i_loop)
    ej_a = ej_a.at[li].set(i_cur)
    sm = sm.at[li].set(sim3_lc.s)
    Rm = Rm.at[li].set(sim3_lc.R)
    tm = tm.at[li].set(sim3_lc.t)
    w = jnp.asarray(w_np, dtype)

    # PRE-PROPAGATE the loop correction to the current KF's covisible group
    # (CorrectLoop, src/LoopClosing.cpp:553-639): corrected Scw(cur) =
    # S_lc * Scw(loop); each neighbor nb gets S_nb_cur * Scw_corr(cur). The
    # pose graph then starts NEAR its optimum — started from the uncorrected
    # estimates, a stiff essential graph (chain + all strong covisibility
    # pairs) under-converges in its iteration budget and leaves the map
    # half-corrected (observed: tracking collapse right after closure #3).
    s_cur_c, R_cur_c, t_cur_c = lie.sim3_mul(
        sim3_lc.s, sim3_lc.R, sim3_lc.t, s0[i_loop], R0[i_loop], t0[i_loop])
    if fix_scale:
        s_cur_c = jnp.ones_like(s_cur_c)
    nb_mask = np.zeros(Kp, bool)
    nb_mask[i_cur] = True
    for k in np.nonzero(W[slot_cur] >= 15)[0]:
        if int(k) in idx_of:
            nb_mask[idx_of[int(k)]] = True
    # relative pose of each neighbor w.r.t. the current KF (uncorrected)
    si_c, Ri_c, ti_c = lie.sim3_inv(s0[i_cur], R0[i_cur], t0[i_cur])
    s_rel, R_rel, t_rel = lie.sim3_mul(s0, R0, t0, si_c, Ri_c, ti_c)
    s_corr, R_corr, t_corr = lie.sim3_mul(s_rel, R_rel, t_rel,
                                          s_cur_c, R_cur_c, t_cur_c)
    nbm = jnp.asarray(nb_mask)
    s0i = jnp.where(nbm, s_corr, s0)
    R0i = jnp.where(nbm[:, None, None], R_corr, R0)
    t0i = jnp.where(nbm[:, None], t_corr, t0)

    free = (jnp.asarray(np.arange(Kp) < K, np.float32)
            .astype(dtype).at[i_loop].set(0.0))          # fix the loop KF + pads
    g = posegraph.Sim3Graph(s=s0i, R=R0i, t=t0i, ei=ei_a, ej=ej_a,
                            s_m=sm, R_m=Rm, t_m=tm, w=w, free=free)
    if mesh is not None:
        # edge-sharded essential graph over the device mesh (the whole-map
        # optimization the reference runs single-threaded at
        # src/Optimizer.cpp:4243; here each device owns an edge shard and
        # one psum per iteration reduces the 7K-dim normal equations)
        from mc_slam.parallel import dist_posegraph
        R_new, s_new, t_new, cost = dist_posegraph.optimize_pose_graph_dist(
            mesh, g, iters=40, fix_scale=fix_scale)
    else:
        R_new, s_new, t_new, cost = posegraph.optimize_pose_graph(
            g, iters=40, fix_scale=fix_scale)
    # pad rows scatter to the same slot as the last real row; make them carry
    # its optimized values (shape-stable clamp gather)
    row = jnp.minimum(jnp.arange(Kp), jnp.asarray(K - 1))
    R_new, s_new, t_new = R_new[row], s_new[row], t_new[row]
    Rwk = Rwk[row]

    # recover body poses: R_wk = R_new^T, P = -1/s R^T t
    Rwk2 = jnp.swapaxes(R_new, -1, -2)
    Pwk2 = -(Rwk2 @ t_new[..., None])[..., 0] / s_new[..., None]
    ns = m.kf_ns
    ks = jnp.asarray(slots_p)
    # rotate/scale velocities with the per-KF rotation correction
    dR = Rwk2 @ jnp.swapaxes(Rwk, -1, -2)                # world-frame correction
    V2 = (dR @ ns.V[ks][..., None])[..., 0] / s_new[..., None]
    ns = ns._replace(P=ns.P.at[ks].set(Pwk2), R=ns.R.at[ks].set(Rwk2),
                     V=ns.V.at[ks].set(V2))

    # correct map points with the surviving KF nearest their CREATION time.
    # Anchoring must be in kf_id (creation-order) space, not slot space: slots
    # are recycled (_alloc_kf_slot), so slot-number proximity can bind a point
    # to a temporally distant KF and teleport it under the per-KF Sim3. Using
    # mp_first_kf also makes culled/recycled mp_ref_kf entries harmless — the
    # creating KF, when still active, is its own nearest id.
    ids = np.array(m.kf_id)[np.asarray(slots)]               # (K,) creation ids
    tid = np.array(m.mp_first_kf)                            # (P,) creation ids
    order = np.argsort(ids)
    ids_sorted = ids[order]
    pos = np.clip(np.searchsorted(ids_sorted, tid), 0, K - 1)
    left = np.clip(pos - 1, 0, K - 1)
    use_left = np.abs(ids_sorted[left] - tid) <= np.abs(ids_sorted[pos] - tid)
    ref_local = jnp.asarray(order[np.where(use_left, left, pos)], jnp.int32)
    mp2 = posegraph.correct_map_points(m.mp_pos, ref_local, s0, R0, t0,
                                       s_new, R_new, t_new)
    mp2 = jnp.where(m.mp_active[:, None], mp2, m.mp_pos)
    return m._replace(kf_ns=ns, mp_pos=mp2)


def _guided_match_count_impl(m: MapState, slot_cur, slot_loop, group_slots,
                             s_lc, R_lc, t_lc, cam, ext=None):
    """The reference's guided-reprojection verification (ComputeSim3,
    src/LoopClosing.cpp:459-498): project every map point observed by the
    loop KF's covisibility GROUP through the candidate Sim3 into the current
    keyframe and count matches. A pairwise Sim3 between two visually aliased
    places (repeating texture) can reach high RANSAC consensus — but the
    group's surrounding geometry will not re-project consistently; the
    reference demands >= 40 group-wide matches before accepting, and this
    gate is what kept it from false closures that a two-view check passes.

    group_slots: (G,) loop-side keyframe slots (the candidate + covisibles).
    Returns the match count."""
    mp = m.kf_mp[group_slots]                                  # (G, F)
    valid = (mp >= 0) & m.kf_feat_valid[group_slots] \
        & m.kf_active[group_slots][:, None]
    sel = jnp.zeros(m.P, bool).at[
        jnp.clip(mp, 0, m.P - 1).reshape(-1)].max(
            valid.reshape(-1), mode="drop")
    sel = sel & m.mp_active
    # world -> loop CAMERA -> (Sim3, camera frames) -> current camera
    Rl = m.kf_ns.R[slot_loop]
    Pl = m.kf_ns.P[slot_loop]
    Xl = (jnp.swapaxes(Rl, -1, -2) @ (m.mp_pos - Pl)[..., None])[..., 0]
    if ext is not None:
        Xl = (ext.Rcb @ Xl[..., None])[..., 0] + ext.tcb
    Xc = s_lc * (R_lc @ Xl[..., None])[..., 0] + t_lc
    z = Xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * Xc[..., 0] / zs + cam.cx
    v = cam.fy * Xc[..., 1] / zs + cam.cy
    vis = sel & (z > 0.1) & (u >= 0) & (u < cam.width) \
        & (v >= 0) & (v < cam.height)
    dist = jnp.linalg.norm(Xc, axis=-1)
    lvl = jnp.clip(jnp.round(jnp.log(jnp.maximum(m.mp_max_dist, 1e-6)
                                     / jnp.maximum(dist, 1e-6))
                             / jnp.log(1.2)), 0, 7).astype(jnp.int32)
    idx, d, ok = matching.search_by_projection(
        jnp.stack([u, v], -1), vis, lvl, m.mp_pm1,
        m.kf_uv[slot_cur], m.kf_level[slot_cur], m.kf_pm1[slot_cur],
        m.kf_feat_valid[slot_cur], radius_px=8.0)
    return jnp.sum(ok)


guided_match_count = jax.jit(_guided_match_count_impl)


@partial(jax.jit, static_argnames=("fix_scale",))
def sim3_ransac_batch(m: MapState, keys, slot_cur, cand_slots, min_inliers,
                      cam, ext=None, fix_scale=False):
    """Sim3 RANSAC + pixel refinement for up to C loop candidates as ONE
    device program (vmapped over candidates).

    The reference iterates candidates sequentially, each with its own solver
    (ComputeSim3, src/LoopClosing.cpp:277-498); on a device that shape costs
    a dispatch->pull round trip PER candidate per keyframe event. Here the
    host pulls one small result tuple and applies the acceptance bars; the
    expensive guided-group verification (a whole-map projection search) runs
    as a SEPARATE dispatch only for a candidate that passed RANSAC — fusing
    it unconditionally for all candidates would run a whole-map search per
    candidate for nothing.

    keys: (C,2) PRNG keys; cand_slots: (C,) candidate KF slots; min_inliers:
    (C,) per-candidate RANSAC consensus bar.
    Returns per-candidate (ok, n_inliers, s, R, t)."""
    from mc_slam.solver.sim3opt import optimize_sim3

    mp_c = m.kf_mp[slot_cur]
    has_c = (mp_c >= 0) & m.kf_feat_valid[slot_cur]
    uv_cur = m.kf_uv[slot_cur]

    def cam_coords(slot, mp):
        # TRUE camera-frame coordinates via the body->camera extrinsics.
        # The body==camera shortcut broke every Sim3 consensus check under a
        # real Tbc (EuRoC's is a ~90 deg rotation): the projection-based
        # inlier gates ran on body coords and no candidate — true revisits
        # included — could ever reach min_inliers (r4: 0/90 accepted).
        Rwb = m.kf_ns.R[slot]
        Pwb = m.kf_ns.P[slot]
        X = m.mp_pos[jnp.clip(mp, 0, m.P - 1)]
        Xb = (jnp.swapaxes(Rwb, -1, -2) @ (X - Pwb)[..., None])[..., 0]
        if ext is None:
            return Xb
        return (ext.Rcb @ Xb[..., None])[..., 0] + ext.tcb

    def one(key, c, min_in):
        mp_l = m.kf_mp[c]
        has_l = (mp_l >= 0) & m.kf_feat_valid[c]
        idx, _, okm = matching.mutual_match(
            m.kf_pm1[slot_cur], has_c, m.kf_pm1[c], has_l,
            max_dist=matching.TH_LOW, ratio=0.9,
            angle_a=m.kf_angle[slot_cur], angle_b=m.kf_angle[c])
        Pc_cur = cam_coords(slot_cur, mp_c)
        Pc_loop = cam_coords(c, mp_l[idx])
        w = okm.astype(jnp.float32)
        res = sim3solver.sim3_ransac(key, Pc_loop, Pc_cur, w, cam.fx,
                                     min_inliers=min_in, fix_scale=fix_scale)
        uv_loop = m.kf_uv[c][idx]
        w_in = res.inliers.astype(jnp.float32) * w
        s2, R2, t2, n2 = optimize_sim3(res.s, res.R, res.t, Pc_cur, Pc_loop,
                                       uv_cur, uv_loop, w_in, cam, iters=10,
                                       fix_scale=fix_scale)
        # keep the refinement only when it strictly improves inlier support
        better = n2 > res.n_inliers
        s = jnp.where(better, s2, res.s)
        R = jnp.where(better, R2, res.R)
        t = jnp.where(better, t2, res.t)
        n_in = jnp.where(better, n2, res.n_inliers)
        # pack into ONE row so the host pays a single device->host pull
        # (five sequential np.asarray pulls cost five round trips)
        return jnp.concatenate([
            jnp.stack([res.ok.astype(s.dtype), n_in.astype(s.dtype), s]),
            R.reshape(9), t])

    return jax.vmap(one)(keys, cand_slots, min_inliers)    # (C, 15)
