"""Map-point statistics refresh: distinctive descriptor (min median Hamming,
MapPoint::ComputeDistinctiveDescriptors, include/MapPoint.h:97) and mean
viewing normal / scale range (UpdateNormalAndDepth, :103) — brute-force numpy
oracle vs the batched kernel."""
import jax.numpy as jnp
import numpy as np

from mc_slam.frontend import orb
from mc_slam.pipeline import mapping
from mc_slam.slam_map.mapstate import empty_map
from mc_slam.solver import factors


def _hamming(a, b):
    return bin(int(a) ^ int(b)).count("1")


def _words_to_int(words):
    v = 0
    for i, w in enumerate(words):
        v |= int(w) << (32 * i)
    return v


def test_distinctive_descriptor_matches_bruteforce(rng):
    K, F, P = 6, 24, 64
    m = empty_map(max_kf=K, max_mp=P, n_feat=F)
    desc = rng.integers(0, 2**32, size=(K, F, 8), dtype=np.uint32)
    pm1 = orb.unpack_pm1(jnp.asarray(desc.reshape(-1, 8))).reshape(K, F, 256)
    # layout: each point p < F observed by the first n_obs[p] KFs at feature p
    n_obs = rng.integers(1, K + 1, size=P)
    kf_mp = np.full((K, F), -1, np.int32)
    for p in range(F):
        for k in range(n_obs[p]):
            kf_mp[k, p] = p
    pos = rng.normal(0, 2, size=(P, 3)).astype(np.float32) + [0, 0, 8]
    ns = m.kf_ns
    Pk = rng.normal(0, 1, size=(K, 3)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, size=(K, F)).astype(np.float32)
    m = m._replace(
        kf_active=jnp.ones(K, bool),
        kf_feat_valid=jnp.ones((K, F), bool),
        kf_mp=jnp.asarray(kf_mp),
        kf_desc=jnp.asarray(desc),
        kf_pm1=pm1,
        kf_level=jnp.asarray(rng.integers(0, 4, size=(K, F)), jnp.int32),
        kf_angle=jnp.asarray(angles),
        kf_ns=ns._replace(P=jnp.asarray(Pk)),
        mp_pos=jnp.asarray(pos),
        mp_active=jnp.ones(P, bool).at[F:].set(False),
        mp_ref_kf=jnp.zeros(P, jnp.int32),
        mp_desc=jnp.asarray(rng.integers(0, 2**32, size=(P, 8), dtype=np.uint32)),
    )
    slots = jnp.arange(8, dtype=jnp.int32) % K
    valid = jnp.asarray([True] * K + [False] * (8 - K))
    ext = factors.identity_extrinsics()
    m2 = mapping.refresh_point_stats(m, slots, valid, ext,
                                     n_levels=jnp.asarray(8, jnp.int32))
    out_desc = np.asarray(m2.mp_desc)
    out_norm = np.asarray(m2.mp_normal)
    for p in range(F):
        obs = [(k, p) for k in range(K) if kf_mp[k, p] == p]
        if n_obs[p] < 2:
            continue  # single observation: untouched
        ds = [_words_to_int(desc[k, f]) for k, f in obs]
        meds = []
        for i, di in enumerate(ds):
            dd = sorted(_hamming(di, dj) for dj in ds)
            meds.append(dd[(len(ds) - 1) // 2])
        best = int(np.argmin(meds))
        kb, fb = obs[best]
        assert np.array_equal(out_desc[p], desc[kb, fb]), p
        # the IC angle travels with the chosen representative
        assert np.isclose(float(np.asarray(m2.mp_angle)[p]), angles[kb, fb]), p
        # mean viewing normal (identity extrinsics: camera center == body P)
        dirs = [pos[p] - Pk[k] for k, _ in obs]
        dirs = [d / np.linalg.norm(d) for d in dirs]
        nrm = np.sum(dirs, 0)
        nrm = nrm / np.linalg.norm(nrm)
        assert np.allclose(out_norm[p], nrm, atol=1e-4), p


def test_refresh_updates_scale_range_at_ref_kf(rng):
    K, F, P = 4, 8, 16
    m = empty_map(max_kf=K, max_mp=P, n_feat=F)
    desc = rng.integers(0, 2**32, size=(K, F, 8), dtype=np.uint32)
    pm1 = orb.unpack_pm1(jnp.asarray(desc.reshape(-1, 8))).reshape(K, F, 256)
    kf_mp = np.full((K, F), -1, np.int32)
    kf_mp[0, 0] = 0
    kf_mp[1, 0] = 0
    pos = np.zeros((P, 3), np.float32)
    pos[0] = [0, 0, 5.0]
    lvl = np.zeros((K, F), np.int32)
    lvl[0, 0] = 2
    m = m._replace(
        kf_active=jnp.ones(K, bool),
        kf_feat_valid=jnp.ones((K, F), bool),
        kf_mp=jnp.asarray(kf_mp), kf_desc=jnp.asarray(desc), kf_pm1=pm1,
        kf_level=jnp.asarray(lvl),
        mp_pos=jnp.asarray(pos),
        mp_active=jnp.ones(P, bool).at[1:].set(False),
        mp_ref_kf=jnp.zeros(P, jnp.int32),
    )
    ext = factors.identity_extrinsics()
    slots = jnp.asarray([0, 1] + [0] * 6, jnp.int32)
    valid = jnp.asarray([True, True] + [False] * 6)
    m2 = mapping.refresh_point_stats(m, slots, valid, ext,
                                     n_levels=jnp.asarray(8, jnp.int32))
    exp_max = 5.0 * 1.2 ** 2
    assert np.isclose(float(m2.mp_max_dist[0]), exp_max, rtol=1e-5)
    assert np.isclose(float(m2.mp_min_dist[0]), exp_max / 1.2 ** 7, rtol=1e-5)


def test_evict_low_value_frees_slots_and_protects():
    """Capacity eviction removes the lowest-value points, never young or
    already-inactive ones, and clears dangling associations."""
    import jax.numpy as jnp
    import numpy as np
    from mc_slam.pipeline import mapping
    from mc_slam.slam_map.mapstate import empty_map

    m = empty_map(max_kf=4, max_mp=64, n_feat=8)
    P = 64
    act = np.ones(P, bool)
    act[60:] = False                       # 4 inactive
    first = np.zeros(P, np.int32)          # created at frame 0 (old)
    first[:8] = 95                         # young (age < 30 at frame 100)
    found = np.full(P, 1.0, np.float32)
    vis = np.full(P, 10.0, np.float32)     # found ratio 0.1 (poor)
    found[8:16] = 10.0                     # good ratio for 8 points
    m = m._replace(mp_active=jnp.asarray(act),
                   mp_first_kf=jnp.asarray(first),
                   mp_found=jnp.asarray(found), mp_visible=jnp.asarray(vis))
    # one KF observes points 16..24 (observation bonus)
    kf_mp = np.full((4, 8), -1, np.int32)
    kf_mp[0] = np.arange(16, 24)
    m = m._replace(kf_mp=jnp.asarray(kf_mp),
                   kf_active=m.kf_active.at[0].set(True),
                   kf_feat_valid=m.kf_feat_valid.at[0].set(True))

    m2, n = mapping.evict_low_value(m, jnp.asarray(100), n_evict=16)
    assert int(n) == 16
    a2 = np.asarray(m2.mp_active)
    assert a2[:8].all(), "young points must be protected"
    assert a2[8:16].all(), "good-found-ratio points survive when worse exist"
    assert a2[16:24].all(), "observed points outrank unobserved"
    # evicted = 16 of the old, unobserved, poor-ratio points
    assert (~a2[24:60]).sum() == 16
    # associations to evicted points are cleared
    mp2 = np.asarray(m2.kf_mp[0])
    assert ((mp2 < 0) | a2[np.clip(mp2, 0, 63)]).all()


def test_scatter_slots_writes_each_real_slot_once():
    """Window BA pads its slot list with a repeat of the last slot; the
    scatter-back must drop the pad rows (a duplicate-index scatter has no
    defined winner on the GPU) so the real slot keeps its BA result."""
    from mc_slam.slam_map.mapstate import scatter_slots
    ks = jnp.asarray([3, 0, 2, 2, 2], jnp.int32)
    put = scatter_slots(ks, 3, 8)
    np.testing.assert_array_equal(np.asarray(put), [3, 0, 2, 8, 8])
    w = jnp.asarray([1.0, 2.0, 3.0, -1.0, -1.0])   # pad rows: stale copies
    out = jnp.zeros(8).at[put].set(w, mode="drop")
    np.testing.assert_array_equal(np.asarray(out),
                                  [2.0, 0, 3.0, 1.0, 0, 0, 0, 0])


def test_padded_window_prune_keeps_real_rows(rng):
    """prune_associations over a window padded with its newest keyframe: the
    newest keyframe's pruned rows survive the pad rows' unpruned copies."""
    K, F, P = 6, 8, 32
    rows = rng.integers(0, P, (K, F)).astype(np.int32)
    m = empty_map(max_kf=K, max_mp=P, n_feat=F)._replace(
        kf_mp=jnp.asarray(rows))
    ks = jnp.asarray([1, 4, 4, 4], jnp.int32)      # window [1, 4] + 2 pads
    chi2 = np.zeros((4, F), np.float32)
    chi2[1, :3] = 1e3                              # outliers in slot 4
    valid = np.zeros((4, F), np.float32)
    valid[:2] = 1.0                                # pad observations masked
    m2 = mapping.prune_associations(
        m, ks, jnp.asarray(chi2.reshape(-1)), jnp.asarray(valid.reshape(-1)),
        jnp.asarray(5.991), 2)
    out = np.asarray(m2.kf_mp)
    assert (out[4, :3] == -1).all()
    np.testing.assert_array_equal(out[4, 3:], rows[4, 3:])
    np.testing.assert_array_equal(out[[0, 1, 2, 3, 5]], rows[[0, 1, 2, 3, 5]])
