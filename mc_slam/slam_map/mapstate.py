"""The SLAM map as fixed-capacity struct-of-arrays (device-resident).

Replaces the reference's pointer-graph data model (Map/KeyFrame/MapPoint/Frame,
src/{Map,KeyFrame,MapPoint,Frame}.cpp) with padded tables + masks:

* keyframe table   : NavState + timestamp + id, `kf_active` mask
* map-point table  : position, descriptor, normal, scale-distance range,
                     found/visible counters, `mp_active` mask
* observation table: per-keyframe fixed-width feature rows — undistorted pixel,
                     level, packed descriptor, and the map-point index each
                     feature observes (-1 = none). This one table encodes what
                     the reference scatters across Frame.mvpMapPoints,
                     MapPoint.mObservations and the covisibility graph —
                     covisibility weights are recomputed on demand as one
                     segment/matmul pass instead of being maintained by hand.

The reference's per-object mutexes and the big map lock disappear: every pipeline
stage is a pure function MapState -> MapState, and stages are serialized by the
host orchestrator (epoch-style, SURVEY.md section 7 "design stance").
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam.imu.navstate import NavState, navstate_identity


class MapState(NamedTuple):
    # --- keyframes ---
    kf_ns: NavState          # (K,...) body NavStates (world-from-body)
    kf_time: jnp.ndarray     # (K,)
    kf_id: jnp.ndarray       # (K,) int32 original frame id (monotonic)
    kf_active: jnp.ndarray   # (K,) bool
    # --- per-keyframe features (observation table) ---
    kf_uv: jnp.ndarray       # (K, F, 2) undistorted pixels
    kf_level: jnp.ndarray    # (K, F) int32
    kf_angle: jnp.ndarray    # (K, F) float32 IC angle (rad)
    kf_ur: jnp.ndarray       # (K, F) right-image u (stereo/RGB-D); -1 = mono
    kf_desc: jnp.ndarray     # (K, F, 8) uint32
    kf_pm1: jnp.ndarray      # (K, F, 256) int8
    kf_feat_valid: jnp.ndarray  # (K, F) bool
    kf_mp: jnp.ndarray       # (K, F) int32 map-point index or -1
    # --- IMU chain: preintegration from the previous active KF ---
    kf_preint: object        # PreintState batch (K, ...)
    # --- map points ---
    mp_pos: jnp.ndarray      # (P, 3)
    mp_desc: jnp.ndarray     # (P, 8) uint32 representative descriptor
    mp_pm1: jnp.ndarray      # (P, 256) int8
    mp_normal: jnp.ndarray   # (P, 3) mean viewing direction
    mp_min_dist: jnp.ndarray  # (P,) scale-invariance range
    mp_max_dist: jnp.ndarray  # (P,)
    mp_ref_kf: jnp.ndarray   # (P,) int32 reference keyframe slot
    mp_angle: jnp.ndarray    # (P,) float32 IC angle of the anchoring observation
    mp_found: jnp.ndarray    # (P,) float32 found counter
    mp_visible: jnp.ndarray  # (P,) float32 visible counter
    mp_first_kf: jnp.ndarray  # (P,) int32 id of creating KF (culling rule)
    mp_active: jnp.ndarray   # (P,) bool

    @property
    def K(self):
        return self.kf_active.shape[0]

    @property
    def P(self):
        return self.mp_active.shape[0]

    @property
    def F(self):
        return self.kf_feat_valid.shape[1]


def empty_map(max_kf: int, max_mp: int, n_feat: int, dtype=jnp.float32) -> MapState:
    from mc_slam.imu.preintegration import preint_identity
    K, P, F = max_kf, max_mp, n_feat
    return MapState(
        kf_ns=navstate_identity((K,), dtype),
        kf_time=jnp.zeros(K, dtype),
        kf_id=jnp.full(K, -1, jnp.int32),
        kf_active=jnp.zeros(K, bool),
        kf_uv=jnp.zeros((K, F, 2), dtype),
        kf_level=jnp.zeros((K, F), jnp.int32),
        kf_angle=jnp.zeros((K, F), dtype),
        kf_ur=jnp.full((K, F), -1.0, dtype),
        kf_desc=jnp.zeros((K, F, 8), jnp.uint32),
        kf_pm1=jnp.zeros((K, F, 256), jnp.int8),
        kf_feat_valid=jnp.zeros((K, F), bool),
        kf_mp=jnp.full((K, F), -1, jnp.int32),
        kf_preint=preint_identity((K,), dtype),
        mp_pos=jnp.zeros((P, 3), dtype),
        mp_desc=jnp.zeros((P, 8), jnp.uint32),
        mp_pm1=jnp.zeros((P, 256), jnp.int8),
        mp_normal=jnp.zeros((P, 3), dtype),
        mp_min_dist=jnp.zeros(P, dtype),
        mp_max_dist=jnp.zeros(P, dtype),
        mp_ref_kf=jnp.zeros(P, jnp.int32),
        mp_angle=jnp.zeros(P, dtype),
        mp_found=jnp.zeros(P, dtype),
        mp_visible=jnp.zeros(P, dtype),
        mp_first_kf=jnp.zeros(P, jnp.int32),
        mp_active=jnp.zeros(P, bool),
    )


@jax.jit
def covisibility_weights(m: MapState, kf_slot):
    """Shared-map-point counts between `kf_slot` and every other KF — the
    covisibility weights of KeyFrame::UpdateConnections (src/KeyFrame.cpp:668),
    recomputed on demand as a one-hot matmul over the observation table."""
    P = m.P
    obs = (m.kf_mp >= 0) & m.kf_feat_valid                # (K, F)
    # membership matrix: does KF k observe map point p? -> (K, P) via scatter
    kf_sees = jnp.zeros((m.K, P), jnp.float32)
    flat_k = jnp.repeat(jnp.arange(m.K), m.F)
    flat_p = jnp.clip(m.kf_mp.reshape(-1), 0, P - 1)
    w = obs.reshape(-1).astype(jnp.float32)
    kf_sees = kf_sees.at[flat_k, flat_p].max(w)
    this = kf_sees[kf_slot]                               # (P,)
    return kf_sees @ (this * m.mp_active)                 # (K,)


@jax.jit
def covisibility_matrix(m: MapState):
    """(K, K) shared-map-point counts between every keyframe pair — one
    membership build + one matmul. Loop detection consumes whole rows per
    candidate; computing them one at a time costs a dispatch+pull each."""
    P = m.P
    obs = (m.kf_mp >= 0) & m.kf_feat_valid
    kf_sees = jnp.zeros((m.K, P), jnp.float32)
    flat_k = jnp.repeat(jnp.arange(m.K), m.F)
    flat_p = jnp.clip(m.kf_mp.reshape(-1), 0, P - 1)
    kf_sees = kf_sees.at[flat_k, flat_p].max(obs.reshape(-1).astype(jnp.float32))
    kf_sees = kf_sees * m.mp_active[None, :] * m.kf_active[:, None]
    return kf_sees @ kf_sees.T


@jax.jit
def observation_counts(m: MapState):
    """(P,) number of keyframes observing each map point."""
    obs = ((m.kf_mp >= 0) & m.kf_feat_valid & m.kf_active[:, None])
    P = m.P
    kf_sees = jnp.zeros((m.K, P), jnp.float32)
    flat_k = jnp.repeat(jnp.arange(m.K), m.F)
    flat_p = jnp.clip(m.kf_mp.reshape(-1), 0, P - 1)
    kf_sees = kf_sees.at[flat_k, flat_p].max(obs.reshape(-1).astype(jnp.float32))
    return jnp.sum(kf_sees, axis=0) * m.mp_active


def scatter_slots(ks, n_real, K):
    """Scatter-back index of a padded keyframe-slot list: rows from `n_real`
    on point past the K-slot table, so a scatter with mode="drop" writes each
    real slot exactly once. (Pad rows repeat a real slot for the gather; a
    scatter with duplicate indices has no defined winner on the GPU, so the
    pad's stale copy could overwrite the real result.)"""
    return jnp.where(jnp.arange(ks.shape[0]) < n_real, ks, K)
