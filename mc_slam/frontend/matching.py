"""Hamming-distance data association kernels.

Replaces ORBmatcher (src/ORBmatcher.cpp): TH_HIGH=100, TH_LOW=50, 30-bin
rotation histogram, NN-ratio test, windowed projection search. The CPU design
(per-feature candidate lists via a 64x48 grid) becomes dense masked distance
matrices: the full NxM Hamming matrix is one int8 GEMM
(d = (256 - a.b)/2 for +/-1 descriptors), and every search mode is a mask.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
BIG = np.int32(10_000)   # host constant: a device-array constant would be captured by every jit that closes over it


def hamming_matrix(pm1_a, pm1_b):
    """(Na, 256) x (Nb, 256) +/-1 int8 -> (Na, Nb) int32 Hamming distances.

    dot = 256 - 2*hamming  =>  hamming = (256 - dot) / 2. One integer GEMM
    with int8 inputs and int32 accumulation (exact at any precision setting).
    """
    dot = jax.lax.dot_general(
        pm1_a, pm1_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32)
    return (256 - dot) // 2


def hamming_matrix_popcount(desc_a, desc_b):
    """Packed (Na,8) x (Nb,8) uint32 via XOR+popcount (reference DescriptorDistance,
    src/ORBmatcher.cpp:25). Useful for small candidate sets / validation."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def rotation_consistency_mask(angle_a, angle_b, match_b_for_a, matched_mask,
                              keep_bins=3, coverage=0.9,
                              min_concentration=0.5, participate=None):
    """30-bin relative-rotation histogram filter (ORBmatcher::ComputeThreeMaxima,
    src/ORBmatcher.cpp:1813-1850): keep matches whose angle difference falls in
    the most-populated bins, dropping even a top bin whose count falls below
    0.1x the maximum (the reference's max2 < 0.1*max1 cutoff).

    Bin selection generalizes the reference's fixed top-3 with one widening:
    beyond the top `keep_bins`, further bins are kept while the cumulative mass
    of better bins is below `coverage` (still subject to the 0.1*max bar). On
    real imagery ORB angles are repeatable, the histogram concentrates >90% in
    ~3 bins, and this reduces to the reference's rule; on texture where the IC
    angle is noisy (isotropic blobs) the reference would throw away the entire
    good-match tail, while the coverage rule widens just enough.

    Concentration guard: the prune only fires when the top-`keep_bins` bins
    hold at least `min_concentration` of the matched mass. Rotation
    consistency presumes all `angle_a` entries were measured in a common
    orientation; map-point representative angles come from heterogeneous
    observer keyframes (ComputeDistinctiveDescriptors picks any observation),
    so their delta-angle histogram is flat and the filter would discard true
    matches wholesale — which is why the reference's local-map projection
    search (ORBmatcher.cpp:63) applies NO rotation check at all. A flat
    histogram (top-3 mass < min_concentration) disables the prune,
    reproducing that behavior; a peaked one (single-frame angle sources,
    SearchByBoW-like) keeps the reference's outlier rejection.

    `participate` (per-a bool, optional): only these rows enter the histogram
    and only they can be pruned — non-participants always pass. Used for the
    frame-to-frame prune during map tracking: points observed in the LAST
    frame carry that frame's keypoint angle (a single consistent source, like
    the reference's SearchByProjection(CurrentFrame, LastFrame) rotHist,
    src/ORBmatcher.cpp:1511), while points not seen last frame have no
    consistent angle and skip the check (like TrackLocalMap's un-checked
    search)."""
    db = angle_a - angle_b[match_b_for_a]
    two_pi = 2.0 * jnp.pi
    db = jnp.mod(db, two_pi)
    bins = jnp.clip((db * (HISTO_BINS / two_pi)).astype(jnp.int32), 0, HISTO_BINS - 1)
    in_hist = matched_mask if participate is None else (matched_mask & participate)
    hist = jnp.zeros(HISTO_BINS, jnp.int32).at[bins].add(in_hist.astype(jnp.int32))
    n_total = jnp.maximum(jnp.sum(hist), 1)
    order = jnp.argsort(-hist)                      # bins by population, desc
    hsort = hist[order]
    csum = jnp.cumsum(hsort)
    # rank r is kept if the mass of strictly-better bins is < coverage target
    rank_kept = (jnp.concatenate([jnp.zeros(1, csum.dtype), csum[:-1]])
                 < coverage * n_total)
    rank_kept = rank_kept | (jnp.arange(HISTO_BINS) < keep_bins)
    # the 0.1*max1 cutoff (ComputeThreeMaxima, src/ORBmatcher.cpp:1813-1850)
    rank_kept = rank_kept & (hsort.astype(jnp.float32)
                             >= 0.1 * hsort[0].astype(jnp.float32))
    keep_bin = jnp.zeros(HISTO_BINS, jnp.bool_).at[order].set(
        rank_kept & (hsort > 0))
    concentrated = (csum[keep_bins - 1].astype(jnp.float32)
                    >= min_concentration * n_total.astype(jnp.float32))
    passed = keep_bin[bins] | ~concentrated
    if participate is not None:
        passed = passed | ~participate
    return matched_mask & passed


def match_nn(dist, mask, max_dist=TH_LOW, ratio=None, ratio_mask=None):
    """Mutual-free nearest-neighbor match from a masked distance matrix.

    dist: (Na, Nb) int32; mask: (Na, Nb) bool candidate gate.
    Returns (idx_b (Na,) int32, best_dist (Na,), ok (Na,) bool).
    ratio: optional best < ratio * second_best test (reference mfNNratio).
    ratio_mask: optional wider gate over which the second-best is taken. When a
    geometric gate (epipolar/window) prunes candidates, the ratio test must
    still measure DESCRIPTOR ambiguity over all plausible candidates —
    otherwise pruning the true second-best lets geometrically-consistent wrong
    matches pass the ratio test (self-similar texture failure mode).
    """
    d = jnp.where(mask, dist, BIG)
    idx = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    ok = best <= max_dist
    if ratio is not None:
        dr = jnp.where(ratio_mask, dist, BIG) if ratio_mask is not None else d
        d2 = dr.at[jnp.arange(d.shape[0]), idx].set(BIG)
        second = jnp.min(d2, axis=1)
        ok = ok & (best.astype(jnp.float32) < ratio * second.astype(jnp.float32))
    return idx, best, ok


def resolve_duplicates(idx_b, best, ok, Nb):
    """Keep only the best match per target b (reference replaces worse duplicates,
    e.g. SearchByProjection dedup). Returns updated ok mask."""
    d = jnp.where(ok, best, BIG)
    best_for_b = jnp.full((Nb,), BIG).at[idx_b].min(d)
    # an entry survives if it achieves the per-b minimum; break exact ties by
    # keeping the lowest row index
    is_min = ok & (d == best_for_b[idx_b])
    rows = jnp.arange(idx_b.shape[0], dtype=jnp.int32)
    first_row = jnp.full((Nb,), jnp.int32(2**30)).at[idx_b].min(
        jnp.where(is_min, rows, jnp.int32(2**30)))
    return is_min & (first_row[idx_b] == rows)


def window_mask(uv_a, uv_b, radius, level_a=None, level_b=None, level_tol=1):
    """(Na, Nb) gate: |uv_a - uv_b| within a square window of `radius` pixels
    (the grid-search window of GetFeaturesInArea, src/Frame.cpp:562), optionally
    constrained to nearby pyramid levels."""
    du = jnp.abs(uv_a[:, None, 0] - uv_b[None, :, 0])
    dv = jnp.abs(uv_a[:, None, 1] - uv_b[None, :, 1])
    m = (du < radius) & (dv < radius)
    if level_a is not None:
        dl = jnp.abs(level_a[:, None] - level_b[None, :])
        m = m & (dl <= level_tol)
    return m


def search_by_projection(proj_uv, proj_valid, proj_level, proj_pm1,
                         feat_uv, feat_level, feat_pm1, feat_valid,
                         radius_px, max_dist=TH_HIGH, ratio=0.9,
                         proj_angle=None, feat_angle=None,
                         proj_angle_valid=None):
    """Project-and-match: map points (projected to proj_uv) vs frame features.

    Mirrors ORBmatcher::SearchByProjection (map-points variant, ORBmatcher.h:38-61):
    windowed candidate gate by predicted position and scale level, Hamming NN with
    ratio test, per-feature dedup. When both `proj_angle` (anchoring-observation
    angle per map point) and `feat_angle` are given, the reference's 30-bin
    rotation-consistency filter (src/ORBmatcher.cpp:325-332) runs as a post-match
    histogram prune.

    XLA fuses the gate, the masked min/argmin and the ratio test into
    reductions over the Hamming GEMM's output (the span is named
    "search_by_projection" in profiler traces).

    Returns (feat_idx (Nm,), dist (Nm,), ok (Nm,)) — a feature index per map point.
    """
    with jax.named_scope("search_by_projection"):
        dist = hamming_matrix(proj_pm1, feat_pm1)
        gate = window_mask(proj_uv, feat_uv, radius_px, proj_level, feat_level)
        gate = gate & proj_valid[:, None] & feat_valid[None, :]
        idx, best, ok = match_nn(dist, gate, max_dist=max_dist, ratio=ratio)
        ok = resolve_duplicates(idx, best, ok, feat_uv.shape[0])
        if proj_angle is not None and feat_angle is not None:
            ok = rotation_consistency_mask(proj_angle, feat_angle, idx, ok,
                                           participate=proj_angle_valid)
    return idx, best, ok


def search_for_initialization(f0_uv, f0_pm1, f0_valid, f1_uv, f1_pm1, f1_valid,
                              radius=100.0, max_dist=TH_LOW, ratio=0.9,
                              f0_angle=None, f1_angle=None):
    """Frame-frame matching for monocular 2-view bootstrap
    (ORBmatcher::SearchForInitialization, src/ORBmatcher.cpp): window around the
    same position, low threshold, ratio test, dedup, rotation-consistency prune
    (the reference runs it with mbCheckOrientation=true)."""
    dist = hamming_matrix(f0_pm1, f1_pm1)
    gate = window_mask(f0_uv, f1_uv, radius)
    gate = gate & f0_valid[:, None] & f1_valid[None, :]
    idx, best, ok = match_nn(dist, gate, max_dist=max_dist, ratio=ratio)
    ok = resolve_duplicates(idx, best, ok, f1_uv.shape[0])
    if f0_angle is not None and f1_angle is not None:
        ok = rotation_consistency_mask(f0_angle, f1_angle, idx, ok)
    return idx, best, ok


def mutual_match(pm1_a, valid_a, pm1_b, valid_b, max_dist=TH_LOW, ratio=0.75,
                 angle_a=None, angle_b=None):
    """Unwindowed mutual NN matching (used where the reference uses SearchByBoW —
    the BoW node gating is a CPU pruning trick; as one GEMM the full matrix is
    cheaper than the bookkeeping). Optional angles enable the rotation-histogram
    prune exactly as SearchByBoW does (src/ORBmatcher.cpp:325-332)."""
    dist = hamming_matrix(pm1_a, pm1_b)
    gate = valid_a[:, None] & valid_b[None, :]
    idx_ab, best_ab, ok_ab = match_nn(dist, gate, max_dist=max_dist, ratio=ratio)
    idx_ba = jnp.argmin(jnp.where(gate, dist, BIG).T, axis=1)
    mutual = idx_ba[idx_ab] == jnp.arange(pm1_a.shape[0])
    ok = ok_ab & mutual
    if angle_a is not None and angle_b is not None:
        ok = rotation_consistency_mask(angle_a, angle_b, idx_ab, ok)
    return idx_ab, best_ab, ok
