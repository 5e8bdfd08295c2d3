"""Local-mapping stage kernels (jitted, fixed-shape).

Replaces LocalMapping (src/LocalMapping.cpp): map-point culling (:1189), new
map-point creation by epipolar-matched triangulation with covisible neighbors
(:1241), neighbor fusion (:1550), local-BA problem gather/scatter, and keyframe
culling (:1777). All dynamic structure (variable match counts, free map slots)
is padded + masked; free-slot allocation uses a sort over the inactive mask.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.frontend import matching
from mc_slam.geometry.triangulation import parallax_cos, triangulate_two_view
from mc_slam.slam_map.mapstate import (MapState, covisibility_weights,
                                            observation_counts, scatter_slots)
from mc_slam.solver import factors

# Scale-invariance band floor. The reference extractor always runs 8 pyramid
# levels (config/euroc.yaml ORBextractor.nLevels), so its creation-time band
# [max_d / 1.2^7, max_d] (src/MapPoint.cpp UpdateNormalAndDepth) never
# collapses. Profiles with fewer levels (tests, fast profiles) must keep at
# least that band width: with e.g. 3 levels the band shrinks to
# [max_d/1.44, max_d] and the tracking distance gate starves the matcher as
# soon as depth changes (round-2 regression, bisected to the narrow band).
BAND_LEVELS_FLOOR = 8


def band_min_dist(max_d, n_levels):
    """Creation-time minimum scale-invariance distance, floored at the
    8-level band the reference always uses."""
    span = jnp.maximum(jnp.asarray(n_levels, jnp.float32) - 1.0,
                       float(BAND_LEVELS_FLOOR - 1))
    return max_d / (1.2 ** span)

# epipolar pre-gate threshold on squared point-to-line distance, in units of
# 3.84 * sigma^2(level) (CheckDistEpipolarLine, src/ORBmatcher.cpp)
EPI_CHI2 = 36.0


# ---------------------------------------------------------------------------
# Map-point culling (LocalMapping::MapPointCulling, src/LocalMapping.cpp:1189):
# bad if found/visible < 0.25, or if >= 2 KFs old with < 3 observations.
# ---------------------------------------------------------------------------

@jax.jit
def cull_map_points(m: MapState, current_kf_id, min_obs=3):
    """min_obs: 3 for monocular, 2 for stereo/RGB-D (the reference's nThObs)."""
    obs_n = observation_counts(m)
    found_ratio = m.mp_found / jnp.maximum(m.mp_visible, 1.0)
    age = current_kf_id - m.mp_first_kf
    bad = (found_ratio < 0.25) & (m.mp_visible >= 4)
    bad = bad | ((age >= 2) & (obs_n < min_obs) & (age <= 4))
    deactivate = m.mp_active & bad
    new_active = m.mp_active & ~bad
    # remove dangling feature associations
    mp_ok = jnp.concatenate([new_active, jnp.asarray([False])])  # -1 -> last
    kf_mp = jnp.where(mp_ok[jnp.clip(m.kf_mp, -1, m.P - 1)] & (m.kf_mp >= 0),
                      m.kf_mp, -1)
    return m._replace(mp_active=new_active, kf_mp=kf_mp), jnp.sum(deactivate)


@jax.jit
def cull_orphans(m: MapState, current_kf_id, min_age=30):
    """Capacity-pressure sweep: deactivate long-lived points with <=1
    observer. The reference deletes such points eagerly
    (MapPoint::EraseObservation -> SetBadFlag at nObs<=2); in a fixed-capacity
    table they otherwise accumulate as zombies until triangulation starves
    for free slots (observed as tracking loss at map capacity on long runs).
    Run ONLY under slot pressure — a standing orphan rule erases points
    faster than triangulation rebuilds them when pruning is aggressive."""
    obs_n = observation_counts(m)
    age = current_kf_id - m.mp_first_kf
    bad = m.mp_active & (obs_n <= 1) & (age > min_age)
    new_active = m.mp_active & ~bad
    mp_ok = jnp.concatenate([new_active, jnp.asarray([False])])
    kf_mp = jnp.where(mp_ok[jnp.clip(m.kf_mp, -1, m.P - 1)] & (m.kf_mp >= 0),
                      m.kf_mp, -1)
    return m._replace(mp_active=new_active, kf_mp=kf_mp), jnp.sum(bad)


@partial(jax.jit, static_argnames=("n_evict",))
def evict_low_value(m: MapState, current_kf_id, n_evict: int):
    """Capacity-pressure eviction: deactivate the `n_evict` lowest-value
    active points so triangulation never starves for free slots.

    The reference's map is unbounded (std::set<MapPoint*>, src/Map.cc) and
    relies on MapPointCulling alone; a fixed-capacity SoA table additionally
    needs a bounded-memory policy or a full table silently allocates nothing
    (observed in round 2: euroc clone pinned at 16384/16384 and tracking
    starved). Value ranking, low to high: few active-KF observations first,
    then poor found/visible ratio; points younger than 30 frames are
    protected (they haven't had the chance to be observed)."""
    obs_n = observation_counts(m)
    found_ratio = m.mp_found / jnp.maximum(m.mp_visible, 1.0)
    age = current_kf_id - m.mp_first_kf
    score = obs_n * 10.0 + found_ratio
    protected = (~m.mp_active) | (age < 30)
    score = jnp.where(protected, jnp.inf, score)
    order = jnp.argsort(score)[:n_evict]
    evictable = jnp.isfinite(score[order])
    idx = jnp.where(evictable, order, m.P)
    new_active = m.mp_active.at[idx].set(False, mode="drop")
    mp_ok = jnp.concatenate([new_active, jnp.asarray([False])])
    kf_mp = jnp.where(mp_ok[jnp.clip(m.kf_mp, -1, m.P - 1)] & (m.kf_mp >= 0),
                      m.kf_mp, -1)
    return m._replace(mp_active=new_active, kf_mp=kf_mp), jnp.sum(evictable)


# ---------------------------------------------------------------------------
# New map points: triangulate epipolar matches between the new KF and a
# neighbor KF. One neighbor per call (host loops over top-N covisible KFs).
# ---------------------------------------------------------------------------

class TriangulationBudget(NamedTuple):
    max_new: int


@partial(jax.jit, static_argnames=("max_new",))
def create_points_with_neighbor(m: MapState, kf_a, kf_b, cam: Camera,
                                ext: factors.Extrinsics, max_new: int = 256,
                                max_dist=matching.TH_LOW, min_parallax_cos=0.99996,
                                n_levels=8):
    """Triangulate new landmarks from unassociated features of KF a vs KF b.

    Mirrors CreateNewMapPoints (src/LocalMapping.cpp:1241): match free features
    along epipolar geometry (here: descriptor NN + epipolar residual gate),
    triangulate, audit depth/parallax/reprojection, allocate into free slots.
    """
    Fn = m.F
    # camera poses (world-from-camera) from body NavStates
    def cam_pose(k):
        Rwb = m.kf_ns.R[k]
        Pwb = m.kf_ns.P[k]
        Rbc = jnp.swapaxes(ext.Rcb, -1, -2)
        pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
        return Rwb @ Rbc, (Rwb @ pbc[..., None])[..., 0] + Pwb

    Rwc_a, Cwa = cam_pose(kf_a)
    Rwc_b, Cwb = cam_pose(kf_b)

    free_a = m.kf_feat_valid[kf_a] & (m.kf_mp[kf_a] < 0)
    free_b = m.kf_feat_valid[kf_b] & (m.kf_mp[kf_b] < 0)
    dist = matching.hamming_matrix(m.kf_pm1[kf_a], m.kf_pm1[kf_b])
    gate = free_a[:, None] & free_b[None, :]

    # baseline / median-scene-depth ratio (CreateNewMapPoints,
    # src/LocalMapping.cpp:1241: mono skips a neighbor when
    # baseline/medianDepth < 0.01). Median depth from KF a's existing
    # landmark associations (masked-median via sort).
    mp_a = m.kf_mp[kf_a]
    has_a = (mp_a >= 0) & m.kf_feat_valid[kf_a]
    Pc_a = (jnp.swapaxes(Rwc_a, -1, -2)
            @ (m.mp_pos[jnp.clip(mp_a, 0, m.P - 1)] - Cwa)[..., None])[..., 0]
    z_sorted = jnp.sort(jnp.where(has_a, Pc_a[..., 2], jnp.inf))
    n_assoc = jnp.sum(has_a)
    med_z = jnp.where(n_assoc > 0,
                      z_sorted[jnp.clip(n_assoc // 2, 0, Fn - 1)], 1.0)
    baseline = jnp.linalg.norm(Cwa - Cwb)
    bd_ratio = baseline / jnp.maximum(med_z, 1e-6)
    enough_baseline = bd_ratio > 0.01

    # normalized coords
    def norm(uv):
        return jnp.stack([(uv[..., 0] - cam.cx) / cam.fx,
                          (uv[..., 1] - cam.cy) / cam.fy], -1)
    xn_a_all = norm(m.kf_uv[kf_a])
    xn_b_all = norm(m.kf_uv[kf_b])

    # epipolar pre-gate (ORBmatcher::SearchForTriangulation constrains candidates
    # to the epipolar line BEFORE descriptor matching, src/ORBmatcher.cpp
    # CheckDistEpipolarLine): point-to-line distance in KF b under the essential
    # matrix of the relative camera pose, thresholded at 3.84 sigma per level.
    R_ba = jnp.swapaxes(Rwc_b, -1, -2) @ Rwc_a
    t_ba = (jnp.swapaxes(Rwc_b, -1, -2) @ (Cwa - Cwb)[..., None])[..., 0]
    E = lie.hat(t_ba) @ R_ba
    xa_h = jnp.concatenate([xn_a_all, jnp.ones((Fn, 1), xn_a_all.dtype)], -1)
    xb_h = jnp.concatenate([xn_b_all, jnp.ones((Fn, 1), xn_b_all.dtype)], -1)
    l_b = xa_h @ E.T                                        # (Fa,3) epipolar lines
    num = jnp.abs(l_b @ xb_h.T)                             # (Fa,Fb)
    den = jnp.sqrt(l_b[:, 0] ** 2 + l_b[:, 1] ** 2)[:, None]
    d_px = num / jnp.maximum(den, 1e-12) * cam.fx           # approx pixel distance
    sig_b = 1.2 ** m.kf_level[kf_b].astype(jnp.float32)
    # the epipolar-line position error is pose-rotation error amplified by
    # depth/baseline, so at small baselines the tight gate rejects TRUE
    # matches and starves the map (a thin-map tracking-death spiral on
    # rotation-dominant motion). Apply the pre-gate only where the geometry
    # makes it informative (depth/baseline amplification <~ 12x); below that
    # the descriptor ratio + post-hoc reprojection audit remain the filter.
    use_epi = bd_ratio > 0.08
    gate = gate & ((d_px * d_px < EPI_CHI2 * sig_b[None, :] ** 2) | ~use_epi)

    # ratio over the UN-gated free set: the epipolar gate prunes candidates
    # geometrically, but descriptor ambiguity must be judged against every
    # free feature or epipolar-consistent wrong matches slip through
    idx_b, best, ok = matching.match_nn(
        dist, gate, max_dist=max_dist, ratio=0.8,
        ratio_mask=free_a[:, None] & free_b[None, :])
    ok = matching.resolve_duplicates(idx_b, best, ok, Fn)

    xn_a = xn_a_all
    xn_b = xn_b_all[idx_b]
    Xw, da, db = triangulate_two_view(Rwc_a, Cwa, Rwc_b, Cwb, xn_a, xn_b)
    cosp = parallax_cos(Cwa, Cwb, Xw)
    # reprojection audit (2 px at level-0, scaled by level sigma)
    def reproj_err(Rwc, Cw, uv):
        Pc = (jnp.swapaxes(Rwc, -1, -2) @ (Xw - Cw)[..., None])[..., 0]
        z = jnp.maximum(Pc[..., 2], 1e-9)
        u = cam.fx * Pc[..., 0] / z + cam.cx
        v = cam.fy * Pc[..., 1] / z + cam.cy
        return jnp.sum((jnp.stack([u, v], -1) - uv) ** 2, -1)
    e_a = reproj_err(Rwc_a, Cwa, m.kf_uv[kf_a])
    e_b = reproj_err(Rwc_b, Cwb, m.kf_uv[kf_b][idx_b])
    sig_a = 1.2 ** (2.0 * m.kf_level[kf_a].astype(jnp.float32))
    good = ok & (da > 0.05) & (db > 0.05) & (cosp < min_parallax_cos) \
        & (e_a < 5.991 * sig_a) & (e_b < 5.991 * sig_a) \
        & jnp.all(jnp.isfinite(Xw), -1) & enough_baseline

    # keep at most max_new, best Hamming first
    order = jnp.argsort(jnp.where(good, best, matching.BIG))[:max_new]
    take_good = good[order]
    # free map slots: first inactive indices
    slot_order = jnp.argsort(m.mp_active)[:max_new]          # False sorts first
    slot_free = ~m.mp_active[slot_order]
    write = take_good & slot_free
    slots = jnp.where(write, slot_order, m.P)                # drop when not writing

    dist_a = jnp.linalg.norm(Xw[order] - Cwa, axis=-1)
    lvl = m.kf_level[kf_a][order].astype(jnp.float32)
    max_d = dist_a * (1.2 ** lvl)
    min_d = band_min_dist(max_d, n_levels)
    normal = (Xw[order] - Cwa) / jnp.maximum(dist_a, 1e-9)[:, None]

    mp_pos = m.mp_pos.at[slots].set(Xw[order], mode="drop")
    mp_desc = m.mp_desc.at[slots].set(m.kf_desc[kf_a][order], mode="drop")
    mp_pm1 = m.mp_pm1.at[slots].set(m.kf_pm1[kf_a][order], mode="drop")
    mp_angle = m.mp_angle.at[slots].set(m.kf_angle[kf_a][order], mode="drop")
    mp_normal = m.mp_normal.at[slots].set(normal, mode="drop")
    mp_min = m.mp_min_dist.at[slots].set(min_d, mode="drop")
    mp_max = m.mp_max_dist.at[slots].set(max_d, mode="drop")
    mp_ref = m.mp_ref_kf.at[slots].set(kf_a, mode="drop")
    mp_first = m.mp_first_kf.at[slots].set(m.kf_id[kf_a], mode="drop")
    mp_found = m.mp_found.at[slots].set(2.0, mode="drop")
    mp_vis = m.mp_visible.at[slots].set(2.0, mode="drop")
    mp_active = m.mp_active.at[slots].set(True, mode="drop")

    # feature associations in both keyframes
    feat_a = jnp.where(write, order, Fn)
    feat_b = jnp.where(write, idx_b[order], Fn)
    kf_mp = m.kf_mp
    kf_mp = kf_mp.at[kf_a, feat_a].set(slot_order, mode="drop")
    kf_mp = kf_mp.at[kf_b, feat_b].set(slot_order, mode="drop")

    m2 = m._replace(mp_pos=mp_pos, mp_desc=mp_desc, mp_pm1=mp_pm1,
                    mp_angle=mp_angle,
                    mp_normal=mp_normal, mp_min_dist=mp_min, mp_max_dist=mp_max,
                    mp_ref_kf=mp_ref, mp_first_kf=mp_first, mp_found=mp_found,
                    mp_visible=mp_vis, mp_active=mp_active, kf_mp=kf_mp)
    return m2, jnp.sum(write)


# ---------------------------------------------------------------------------
# Fuse (SearchInNeighbors, src/LocalMapping.cpp:1550): project KF a's map points
# into KF b; matched free features gain the association; matched features that
# already hold a different point keep the better-observed one.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_new",))
def create_points_with_neighbors(m: MapState, kf_a, nbrs, cam: Camera,
                                 ext: factors.Extrinsics, max_new: int = 256,
                                 n_levels=8):
    """Triangulate against several neighbors in ONE device program.

    nbrs: (N,) int32 neighbor slots; pass kf_a itself for padding entries —
    a self-pair has zero baseline, fails the enough_baseline gate and writes
    nothing. Replaces N separate create_points_with_neighbor dispatches (each
    a full host->device round trip) with one lax.scan; the chained MapState stays device-resident throughout.
    """
    return create_points_with_neighbor_scan(m, kf_a, nbrs, cam, ext,
                                            max_new, n_levels)


@partial(jax.jit, static_argnames=())
def fuse_neighbors(m: MapState, kf_a, nbrs, nbrs_valid, cam: Camera,
                   ext: factors.Extrinsics):
    """Bidirectional SearchInNeighbors fusion round in ONE device program.

    For each valid neighbor nb: fuse(nb -> kf_a) and fuse(kf_a -> nb).
    Observation counts are computed once inside the program (round-start
    counts; the better-observed arbitration tolerates staleness — see
    fuse_into_keyframe). Replaces 2N+1 dispatches with one scan."""
    obs_n = observation_counts(m)

    def body(m, x):
        src, dst, v = x
        m2, n = fuse_into_keyframe(m, src, dst, cam, ext, obs_n=obs_n,
                                   valid=v)
        return m2, n

    srcs = jnp.concatenate([nbrs, jnp.broadcast_to(kf_a, nbrs.shape)])
    dsts = jnp.concatenate([jnp.broadcast_to(kf_a, nbrs.shape), nbrs])
    vs = jnp.concatenate([nbrs_valid, nbrs_valid])
    m2, ns = jax.lax.scan(body, m, (srcs, dsts, vs))
    return m2, jnp.sum(ns)


@jax.jit
def fuse_into_keyframe(m: MapState, kf_src, kf_dst, cam: Camera,
                       ext: factors.Extrinsics, radius=3.0,
                       max_dist=matching.TH_LOW, obs_n=None, valid=None):
    """obs_n: optional precomputed observation_counts(m). The fusion round
    over N neighbors may pass counts computed once at round start — the
    arbitration ("keep the better-observed point") tolerates counts a few
    associations stale, and the O(K*P) scatter is the dominant cost here."""
    mp_of_src = jnp.where(m.kf_feat_valid[kf_src], m.kf_mp[kf_src], -1)   # (F,)
    src_has = mp_of_src >= 0
    mp_idx = jnp.clip(mp_of_src, 0, m.P - 1)
    # project those points into dst
    Rwb = m.kf_ns.R[kf_dst]
    Pwb = m.kf_ns.P[kf_dst]
    Pb = (jnp.swapaxes(Rwb, -1, -2) @ (m.mp_pos[mp_idx] - Pwb)[..., None])[..., 0]
    Pc = (ext.Rcb @ Pb[..., None])[..., 0] + ext.tcb
    z = Pc[..., 2]
    zs = jnp.maximum(z, 1e-9)
    uv = jnp.stack([cam.fx * Pc[..., 0] / zs + cam.cx,
                    cam.fy * Pc[..., 1] / zs + cam.cy], -1)
    vis = src_has & (z > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < cam.width) \
        & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height) & m.mp_active[mp_idx]

    dist = matching.hamming_matrix(m.mp_pm1[mp_idx], m.kf_pm1[kf_dst])
    gate = matching.window_mask(uv, m.kf_uv[kf_dst], radius)
    gate = gate & vis[:, None] & m.kf_feat_valid[kf_dst][None, :]
    if valid is not None:
        # traced no-op switch for scanned padding pairs (fuse_neighbors)
        gate = gate & (valid > 0)
    fidx, best, ok = matching.match_nn(dist, gate, max_dist=max_dist)
    ok = matching.resolve_duplicates(fidx, best, ok, m.F)

    if obs_n is None:
        obs_n = observation_counts(m)
    cur_mp = m.kf_mp[kf_dst]                                  # (F,)
    tgt_feat = jnp.where(ok, fidx, m.F)
    # association decision at the target feature: keep the better-observed point
    cur_at = cur_mp[jnp.clip(fidx, 0, m.F - 1)]
    cur_obs = jnp.where(cur_at >= 0, obs_n[jnp.clip(cur_at, 0, m.P - 1)], -1.0)
    new_obs = obs_n[mp_idx]
    replace = ok & ((cur_at < 0) | (new_obs >= cur_obs))
    kf_mp = m.kf_mp.at[kf_dst, jnp.where(replace, fidx, m.F)].set(mp_idx, mode="drop")
    return m._replace(kf_mp=kf_mp), jnp.sum(replace & (cur_at < 0))


# ---------------------------------------------------------------------------
# Keyframe culling (LocalMapping::KeyFrameCulling, src/LocalMapping.cpp:1777):
# a KF is redundant if >= 90% of its tracked points are observed by >= 3 other
# KFs. VI guards handled by the host (time gaps, window membership).
# ---------------------------------------------------------------------------

@jax.jit
def kf_redundancy(m: MapState, kf_slot):
    mp = m.kf_mp[kf_slot]
    has = (mp >= 0) & m.kf_feat_valid[kf_slot]
    obs_n = observation_counts(m)
    n_pts = jnp.sum(has)
    redundant = jnp.sum(has & (obs_n[jnp.clip(mp, 0, m.P - 1)] >= 4.0))
    return redundant.astype(jnp.float32) / jnp.maximum(n_pts.astype(jnp.float32), 1.0), n_pts


@jax.jit
def kf_redundancy_all(m: MapState):
    """(ratio (K,), n_pts (K,)) redundancy for EVERY keyframe in one pass —
    the culling loop pulls one array instead of dispatching per candidate."""
    obs_n = observation_counts(m)
    has = (m.kf_mp >= 0) & m.kf_feat_valid                 # (K, F)
    mp = jnp.clip(m.kf_mp, 0, m.P - 1)
    red = jnp.sum(has & (obs_n[mp] >= 4.0), axis=1).astype(jnp.float32)
    n_pts = jnp.sum(has, axis=1)
    return red / jnp.maximum(n_pts.astype(jnp.float32), 1.0), n_pts


@jax.jit
def write_keyframe(m: MapState, slot, P_pose, R_pose, V, bg, ba, t_kf, fid,
                   uv, level, angle, ur, desc, pm1, feat_valid,
                   feat_mp=None, pre=None):
    """All keyframe-table writes of an insertion as ONE device program.

    The eager form is ~30 .at[].set dispatches across the kf_ns/kf_* tables
    per keyframe event; fused it is one dispatch. pre: optional PreintState row;
    feat_mp: optional (F,) association row (KF creation from tracking)."""
    ns = m.kf_ns
    z3 = jnp.zeros(3, ns.P.dtype)
    ns = ns._replace(
        P=ns.P.at[slot].set(P_pose), R=ns.R.at[slot].set(R_pose),
        V=ns.V.at[slot].set(V),
        bg=ns.bg.at[slot].set(bg), ba=ns.ba.at[slot].set(ba),
        dbg=ns.dbg.at[slot].set(z3), dba=ns.dba.at[slot].set(z3))
    m = m._replace(
        kf_ns=ns,
        kf_time=m.kf_time.at[slot].set(t_kf),
        kf_id=m.kf_id.at[slot].set(fid),
        kf_active=m.kf_active.at[slot].set(True),
        kf_uv=m.kf_uv.at[slot].set(uv),
        kf_level=m.kf_level.at[slot].set(level),
        kf_angle=m.kf_angle.at[slot].set(angle),
        kf_ur=m.kf_ur.at[slot].set(ur),
        kf_desc=m.kf_desc.at[slot].set(desc),
        kf_pm1=m.kf_pm1.at[slot].set(pm1),
        kf_feat_valid=m.kf_feat_valid.at[slot].set(feat_valid),
    )
    if feat_mp is not None:
        m = m._replace(kf_mp=m.kf_mp.at[slot].set(feat_mp))
    if pre is not None:
        m = m._replace(kf_preint=jax.tree_util.tree_map(
            lambda a, b: a.at[slot].set(b), m.kf_preint, pre))
    return m


@jax.jit
def prune_associations(m: MapState, ks, chi2, valid, gate, n_real):
    """Clear feature->map-point associations whose post-BA chi2 exceeds the
    gate (the reference's outlier removal after local BA). ks: (n,) window
    slots aligned with the (n*F,) flat chi2/valid, of which the first
    `n_real` are real (the rest pad); gate: scalar or (n*F,) per-observation
    threshold."""
    bad = (chi2 > gate * 1.5) & (valid > 0)
    bad = bad.reshape(ks.shape[0], -1)
    rows = jnp.where(bad, -1, m.kf_mp[ks])
    put = scatter_slots(ks, n_real, m.K)
    return m._replace(kf_mp=m.kf_mp.at[put].set(rows, mode="drop"))


@jax.jit
def deactivate_keyframe(m: MapState, kf_slot):
    """Remove a KF: clear its mask and feature associations. (IMU-chain splicing
    is done by the host, which owns the raw IMU buffers.)"""
    return m._replace(
        kf_active=m.kf_active.at[kf_slot].set(False),
        kf_mp=m.kf_mp.at[kf_slot].set(-1),
    )


# ---------------------------------------------------------------------------
# Point statistics refresh (MapPoint::ComputeDistinctiveDescriptors,
# include/MapPoint.h:97, and MapPoint::UpdateNormalAndDepth, :103): after new
# observations / fusion, re-pick each map point's representative descriptor as
# the observation with minimum MEDIAN Hamming distance to all other
# observations, and recompute the mean viewing normal + scale-invariance
# distance range. Batched over all points seen by the new keyframe, with
# observations gathered from a fixed-size window of observing keyframes.
# ---------------------------------------------------------------------------

@jax.jit
def refresh_point_stats(m: MapState, slots, slot_valid,
                        ext: factors.Extrinsics, n_levels=8):
    """slots: (W,) int32 keyframe slots — slots[0] is the new KF whose observed
    points are refreshed; the rest are its top covisible observers.
    slot_valid: (W,) bool mask for padded entries. Observations in keyframes
    outside this window are not consulted (bounded approximation of the
    reference's all-observations scan)."""
    W = slots.shape[0]
    P, Fn = m.P, m.F
    # inverse lookup: feature index of each window KF observing point p
    kf_mp_w = m.kf_mp[slots]                                   # (W, F)
    fv_w = m.kf_feat_valid[slots] & slot_valid[:, None]
    obs_ok = fv_w & (kf_mp_w >= 0)
    rows = jnp.repeat(jnp.arange(W, dtype=jnp.int32), Fn)
    cols = jnp.where(obs_ok, kf_mp_w, P).reshape(-1)
    feats = jnp.tile(jnp.arange(Fn, dtype=jnp.int32), W)
    inv = jnp.full((W, P + 1), Fn, jnp.int32).at[rows, cols].min(feats)

    touched = m.kf_mp[slots[0]]                                # (F,)
    pt = jnp.clip(touched, 0, P - 1)
    tmask = (touched >= 0) & m.kf_feat_valid[slots[0]] & m.mp_active[pt]

    feat_iw = inv[:, pt].T                                     # (F, W)
    vmask = feat_iw < Fn
    fi = jnp.clip(feat_iw, 0, Fn - 1)
    # gather per-observation descriptors: (F, W, 256) / (F, W, 8)
    pm1_w = jnp.swapaxes(
        jnp.take_along_axis(m.kf_pm1[slots], fi.T[:, :, None], axis=1), 0, 1)
    desc_w = jnp.swapaxes(
        jnp.take_along_axis(m.kf_desc[slots], fi.T[:, :, None], axis=1), 0, 1)
    # pairwise Hamming within each point's observation set: d = (256 - dot)/2
    pf = pm1_w.astype(jnp.float32)
    d = (256.0 - jnp.einsum("fwc,fvc->fwv", pf, pf)) * 0.5     # (F, W, W)
    d = jnp.where(vmask[:, None, :], d, jnp.inf)
    cnt = jnp.sum(vmask, -1)                                   # (F,)
    sortd = jnp.sort(d, axis=-1)
    med_idx = jnp.clip((cnt - 1) // 2, 0, W - 1)
    med = jnp.take_along_axis(sortd, med_idx[:, None, None], axis=-1)[..., 0]
    med = jnp.where(vmask, med, jnp.inf)                       # (F, W)
    best_w = jnp.argmin(med, -1)                               # (F,)
    new_pm1 = jnp.take_along_axis(pm1_w, best_w[:, None, None], axis=1)[:, 0]
    new_desc = jnp.take_along_axis(desc_w, best_w[:, None, None], axis=1)[:, 0]
    # the representative's IC angle must travel with the descriptor: the
    # rotation-consistency histogram compares feat_angle - mp_angle, and a
    # descriptor/angle mismatch scatters true matches out of the dominant bins
    ang_w = jnp.swapaxes(
        jnp.take_along_axis(m.kf_angle[slots], fi.T, axis=1), 0, 1)  # (F, W)
    new_angle = jnp.take_along_axis(ang_w, best_w[:, None], axis=1)[:, 0]

    # mean viewing normal over window observations (UpdateNormalAndDepth)
    Rbc = jnp.swapaxes(ext.Rcb, -1, -2)
    pbc = -(Rbc @ ext.tcb[..., None])[..., 0]
    C_w = (m.kf_ns.R[slots] @ pbc[None, :, None])[..., 0] + m.kf_ns.P[slots]
    dirs = m.mp_pos[pt][:, None, :] - C_w[None, :, :]          # (F, W, 3)
    dirs = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-9)
    normal = jnp.sum(jnp.where(vmask[..., None], dirs, 0.0), 1)
    normal = normal / jnp.maximum(jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    # scale-invariance range re-anchored at the reference KF when it is inside
    # the window (dist * 1.2^level of the anchoring observation)
    is_ref = (slots[None, :] == m.mp_ref_kf[pt][:, None]) & vmask
    ref_in = jnp.any(is_ref, -1)
    w_ref = jnp.argmax(is_ref, -1)
    d_ref = jnp.linalg.norm(
        m.mp_pos[pt] - C_w[jnp.clip(w_ref, 0, W - 1)], axis=-1)
    f_ref = jnp.take_along_axis(fi, w_ref[:, None], axis=1)[:, 0]
    lvl_ref = m.kf_level[slots][w_ref, f_ref].astype(jnp.float32)
    max_d = d_ref * (1.2 ** lvl_ref)
    min_d = band_min_dist(max_d, n_levels)

    write = tmask & (cnt >= 2)
    idx = jnp.where(write, pt, P)
    idx_ref = jnp.where(write & ref_in, pt, P)
    return m._replace(
        mp_pm1=m.mp_pm1.at[idx].set(new_pm1, mode="drop"),
        mp_desc=m.mp_desc.at[idx].set(new_desc, mode="drop"),
        mp_angle=m.mp_angle.at[idx].set(new_angle, mode="drop"),
        mp_normal=m.mp_normal.at[idx].set(normal, mode="drop"),
        mp_max_dist=m.mp_max_dist.at[idx_ref].set(max_d, mode="drop"),
        mp_min_dist=m.mp_min_dist.at[idx_ref].set(min_d, mode="drop"),
    )


@jax.jit
def update_found_visible(m: MapState, visible_mask, found_mask):
    """Tracking bookkeeping: IncreaseVisible/IncreaseFound counters."""
    return m._replace(
        mp_visible=m.mp_visible + visible_mask.astype(m.mp_visible.dtype),
        mp_found=m.mp_found + found_mask.astype(m.mp_found.dtype),
    )


@partial(jax.jit, static_argnames=("min_obs", "n_evict"))
def cull_and_evict(m: MapState, current_kf_id, min_obs: int = 3,
                   n_evict: int = 0):
    """Fused start-of-KF-event landmark maintenance: MapPointCulling plus the
    capacity policies (orphan sweep at >90% occupancy, lowest-value eviction
    at >95%) with the occupancy decisions taken IN-GRAPH — the old host flow
    pulled the active count twice per keyframe event, each pull a full
    device round trip."""
    m, _ = cull_map_points(m, current_kf_id, min_obs)
    n_active = jnp.sum(m.mp_active)

    def sweep(mm):
        mm2, _ = cull_orphans(mm, current_kf_id)
        return mm2

    m = jax.lax.cond(n_active > 0.9 * m.P, sweep, lambda mm: mm, m)
    if n_evict > 0:
        def evict(mm):
            mm2, _ = evict_low_value(mm, current_kf_id, n_evict)
            return mm2

        m = jax.lax.cond(jnp.sum(m.mp_active) > 0.95 * m.P, evict,
                         lambda mm: mm, m)
    return m


@partial(jax.jit, static_argnames=("min_obs",))
def kf_event_stats(m: MapState, slot, min_obs: int = 3):
    """Every scalar/vector the host needs to steer one keyframe event, in a
    single program (ONE pull instead of ~5 round trips): the covisibility row
    of `slot` (KeyFrame::GetCovisiblesByWeight source), per-KF redundancy
    (KeyFrameCulling, src/LocalMapping.cpp:1777), the active-landmark count,
    and the count of well-observed points tracked by `slot`
    (Tracking::NeedNewKeyFrame's TrackedMapPoints(minObs),
    src/Tracking.cpp:1893)."""
    P = m.P
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_active[:, None]
    kf_sees = jnp.zeros((m.K, P), jnp.float32)
    flat_k = jnp.repeat(jnp.arange(m.K), m.F)
    flat_p = jnp.clip(m.kf_mp.reshape(-1), 0, P - 1)
    kf_sees = kf_sees.at[flat_k, flat_p].max(obs.reshape(-1).astype(jnp.float32))
    covis_row = kf_sees @ (kf_sees[slot] * m.mp_active)          # (K,)
    obs_n = jnp.sum(kf_sees, axis=0) * m.mp_active               # (P,)
    has = obs                                                    # (K, F)
    mp = jnp.clip(m.kf_mp, 0, P - 1)
    red = jnp.sum(has & (obs_n[mp] >= 4.0), axis=1).astype(jnp.float32)
    n_pts = jnp.sum(has, axis=1)
    red_ratio = red / jnp.maximum(n_pts.astype(jnp.float32), 1.0)
    mp_ref = m.kf_mp[slot]
    well = ((mp_ref >= 0) & m.kf_feat_valid[slot]
            & (obs_n[jnp.clip(mp_ref, 0, P - 1)] >= min_obs))
    return (covis_row, red_ratio, n_pts, jnp.sum(m.mp_active),
            jnp.sum(well))


@partial(jax.jit, static_argnames=("min_obs", "n_evict", "covis_th",
                                   "max_new"))
def kf_event_pre(m: MapState, slot, current_kf_id, cam: Camera,
                 ext: factors.Extrinsics, n_levels, min_obs: int = 3,
                 n_evict: int = 0, covis_th: int = 15, max_new: int = 256):
    """Landmark maintenance + neighbor selection + triangulation + fusion as
    ONE device program (the pre-BA half of a keyframe event) instead of four
    dispatches with a host round trip between each. Returns (m2, nb4, nbv4, wslots, wvalid)."""
    m = cull_and_evict.__wrapped__(m, current_kf_id, min_obs=min_obs,
                                   n_evict=n_evict)
    nb4, nbv4, wslots, wvalid = kf_neighbors.__wrapped__(
        m, slot, covis_th=covis_th)
    m, _ = create_points_with_neighbor_scan(m, slot, nb4, cam, ext,
                                            max_new=max_new,
                                            n_levels=n_levels)
    m, _ = fuse_neighbors.__wrapped__(m, slot, nb4, nbv4, cam, ext)
    return m, nb4, nbv4, wslots, wvalid


def create_points_with_neighbor_scan(m, kf_a, nbrs, cam, ext, max_new,
                                     n_levels):
    """Unjitted body of create_points_with_neighbors (for fusion into larger
    programs)."""
    def body(m, nb):
        m2, n = create_points_with_neighbor.__wrapped__(
            m, kf_a, nb, cam, ext, max_new=max_new, n_levels=n_levels)
        return m2, n

    m2, ns = jax.lax.scan(body, m, nbrs)
    return m2, jnp.sum(ns)


@partial(jax.jit, static_argnames=("min_obs", "refresh"))
def kf_event_post(m: MapState, slot, wslots, wvalid, ext: factors.Extrinsics,
                  hists, n_levels, min_obs: int = 3, refresh: bool = True):
    """Post-BA half of a keyframe event as ONE device program: point-stat
    refresh, redundancy/ref-tracked stats, and loop-detection scores — with
    the (K,P) observation matrix built ONCE and shared between the stats and
    the covisibility matrix (kf_event_stats and the detector each built
    their own before). Returns (m2, stats_tuple, scores)."""
    if refresh:
        m = refresh_point_stats.__wrapped__(m, wslots, wvalid, ext,
                                            n_levels=n_levels)
    P = m.P
    obs = (m.kf_mp >= 0) & m.kf_feat_valid & m.kf_active[:, None]
    kf_sees = jnp.zeros((m.K, P), jnp.float32)
    flat_k = jnp.repeat(jnp.arange(m.K), m.F)
    flat_p = jnp.clip(m.kf_mp.reshape(-1), 0, P - 1)
    kf_sees = kf_sees.at[flat_k, flat_p].max(
        obs.reshape(-1).astype(jnp.float32))
    sees_act = kf_sees * m.mp_active[None, :]
    W = sees_act @ sees_act.T                                  # (K, K) covis
    covis_row = W[slot]
    obs_n = jnp.sum(kf_sees, axis=0) * m.mp_active             # (P,)
    mp = jnp.clip(m.kf_mp, 0, P - 1)
    red = jnp.sum(obs & (obs_n[mp] >= 4.0), axis=1).astype(jnp.float32)
    n_pts = jnp.sum(obs, axis=1)
    red_ratio = red / jnp.maximum(n_pts.astype(jnp.float32), 1.0)
    mp_ref = m.kf_mp[slot]
    well = ((mp_ref >= 0) & m.kf_feat_valid[slot]
            & (obs_n[jnp.clip(mp_ref, 0, P - 1)] >= min_obs))
    stats = (covis_row, red_ratio, n_pts, jnp.sum(m.mp_active),
             jnp.sum(well))
    scores = hists @ hists[slot]
    return m, stats, scores, W


@partial(jax.jit, static_argnames=("covis_th",))
def kf_neighbors(m: MapState, slot, covis_th: int = 15):
    """Top covisible neighbors of `slot` selected ON DEVICE (the old host-side
    selection pulled a covisibility row per keyframe event — a full device
    round trip). Returns (nb4, nbv4, wslots8, wvalid8): the 4 triangulation /
    fusion partners (padded with `slot`, validity in nbv4) and the 8-slot
    refresh window. Mirrors GetCovisiblesByWeight + the max-weight fallback
    of UpdateConnections (src/KeyFrame.cpp:668-696)."""
    w = covisibility_weights(m, slot) * m.kf_active.astype(jnp.float32)
    w = w.at[slot].set(0.0)
    top_w, top_i = jax.lax.top_k(w, 8)
    ok8 = top_w >= covis_th
    ok8 = ok8.at[0].set(ok8[0] | (top_w[0] > 0))
    nb4 = jnp.where(ok8[:4], top_i[:4], slot)
    nbv4 = ok8[:4].astype(jnp.float32)
    wslots = jnp.concatenate([slot[None].astype(jnp.int32), top_i[:7]])
    wvalid = jnp.concatenate([jnp.ones(1, bool), ok8[:7]])
    return nb4, nbv4, wslots, wvalid
