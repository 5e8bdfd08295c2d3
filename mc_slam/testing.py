"""Plain references and synthetic problems that the tests, chip_smoke.py and
bench.py hold the library to; nothing in the pipeline imports this module.

Matchers: NumPy references for frontend/matching.py, written from the
reference's ORBmatcher rules (src/ORBmatcher.cpp) and independent of the JAX
code: Hamming distances by XOR + popcount over the packed 256-bit
descriptors (DescriptorDistance, :25), and a brute-force projection search
(SearchByProjection's window gate, level gate, NN-ratio test, per-feature
dedup and rotation histogram). The JAX matchers must agree bit for bit:
every output is an integer or a mask. `projection_problem` builds an input
with the structure tracking sees.

Mesh path: `posegraph_compare` and `pipeline_mesh_compare` run the
edge-sharded pose graph and the SlamSystem's mesh wiring (enable_mesh)
against their single-device versions on the same problem.
"""
from __future__ import annotations

import numpy as np

BIG = 10_000
HISTO_BINS = 30


def hamming_popcount(desc_a, desc_b, block=256):
    """(Na, 8) x (Nb, 8) uint32 packed descriptors -> (Na, Nb) int32."""
    desc_a = np.asarray(desc_a, np.uint32)
    desc_b = np.asarray(desc_b, np.uint32)
    out = np.empty((desc_a.shape[0], desc_b.shape[0]), np.int32)
    for i in range(0, desc_a.shape[0], block):
        x = desc_a[i:i + block, None, :] ^ desc_b[None, :, :]
        out[i:i + block] = np.bitwise_count(x).sum(-1)
    return out


def rotation_consistency(angle_a, angle_b, idx, ok, participate=None,
                         keep_bins=3, coverage=0.9, min_concentration=0.5):
    """ComputeThreeMaxima-style histogram prune (src/ORBmatcher.cpp:1813):
    keep matches whose angle difference falls in the top bins (the top
    `keep_bins`, widened while the mass of better bins is below `coverage`,
    each at least 0.1x the top bin), and prune only when the top bins hold
    `min_concentration` of the mass. Non-participants always pass."""
    two_pi = np.float32(2.0 * np.pi)
    db = np.mod(np.asarray(angle_a, np.float32)
                - np.asarray(angle_b, np.float32)[idx], two_pi)
    bins = np.clip((db * np.float32(HISTO_BINS / (2.0 * np.pi)))
                   .astype(np.int32), 0, HISTO_BINS - 1)
    part = np.ones_like(ok) if participate is None else np.asarray(participate)
    hist = np.bincount(bins[ok & part], minlength=HISTO_BINS)
    # thresholds in float32, as the device computes them
    f32 = np.float32
    n_total = f32(max(int(hist.sum()), 1))
    order = np.argsort(-hist, kind="stable")
    keep = np.zeros(HISTO_BINS, bool)
    better = 0
    for rank, b in enumerate(order):
        h = int(hist[b])
        kept = rank < keep_bins or better < f32(coverage) * n_total
        keep[b] = kept and f32(h) >= f32(0.1) * f32(hist[order[0]]) and h > 0
        better += h
    concentrated = (f32(hist[order[:keep_bins]].sum())
                    >= f32(min_concentration) * n_total)
    passed = keep[bins] | (not concentrated) | ~part
    return ok & passed


def search_by_projection(proj_uv, proj_valid, proj_level, proj_desc,
                         feat_uv, feat_level, feat_desc, feat_valid,
                         radius_px, max_dist=100, ratio=0.9, level_tol=1,
                         proj_angle=None, feat_angle=None,
                         proj_angle_valid=None):
    """Brute-force map-point -> feature search. Descriptors are packed
    (.., 8) uint32. Returns (idx (M,), best (M,), ok (M,)) like
    matching.search_by_projection."""
    proj_uv = np.asarray(proj_uv, np.float32)
    feat_uv = np.asarray(feat_uv, np.float32)
    d = hamming_popcount(proj_desc, feat_desc)
    r = np.float32(radius_px)
    gate = ((np.abs(proj_uv[:, None, 0] - feat_uv[None, :, 0]) < r)
            & (np.abs(proj_uv[:, None, 1] - feat_uv[None, :, 1]) < r)
            & (np.abs(np.asarray(proj_level)[:, None]
                      - np.asarray(feat_level)[None, :]) <= level_tol)
            & np.asarray(proj_valid)[:, None] & np.asarray(feat_valid)[None, :])
    dm = np.where(gate, d, BIG)
    rows = np.arange(dm.shape[0])
    idx = np.argmin(dm, axis=1).astype(np.int32)
    best = dm[rows, idx]
    ok = best <= max_dist
    if ratio is not None:
        d2 = dm.copy()
        d2[rows, idx] = BIG
        second = d2.min(axis=1)
        ok &= (best.astype(np.float32)
               < np.float32(ratio) * second.astype(np.float32))
    # one map point per feature: the lowest distance wins, ties to the
    # lowest map-point row
    keep = np.zeros_like(ok)
    winner = {}
    for a in np.nonzero(ok)[0]:
        b = idx[a]
        if b not in winner or best[a] < best[winner[b]]:
            winner[b] = a
    keep[list(winner.values())] = True
    ok = ok & keep
    if proj_angle is not None and feat_angle is not None:
        ok = rotation_consistency(proj_angle, feat_angle, idx, ok,
                                  participate=proj_angle_valid)
    return idx, best.astype(np.int32), ok


def _pack_bits(bits):
    """(N, 256) bool -> (N, 8) uint32, bit i of word w = bits[32 w + i]
    (the layout orb.unpack_pm1 reads)."""
    b = np.packbits(bits.reshape(-1, 8, 32), axis=-1, bitorder="little")
    return np.ascontiguousarray(b).view("<u4").reshape(-1, 8)


def _flips(rng, n, max_bits):
    """(n, 8) uint32 masks with 0..max_bits-1 random bits set."""
    bits = np.zeros((n, 256), bool)
    for j, k in enumerate(rng.integers(0, max_bits, n)):
        bits[j, rng.choice(256, k, replace=False)] = True
    return _pack_bits(bits)


def projection_problem(rng, M, N, width=752, height=480, n_levels=8):
    """A projection-search input with the structure tracking sees: most
    features are noisy views of one map point each (0-59 descriptor bits
    flipped, a few pixels off, the same or a neighbouring level); a sixth
    are near twins of another feature (the NN-ratio test's case); angles sit
    at histogram bin centres, mostly consistent with a few outliers (the
    rotation prune's case). Returns a dict of NumPy arrays; descriptors are
    packed uint32."""
    f32 = np.float32
    n_tw = N // 6
    n_src = N - n_tw
    proj_desc = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    proj_uv = rng.uniform((0, 0), (width, height), (M, 2)).astype(f32)
    proj_level = rng.integers(0, n_levels, M).astype(np.int32)
    src = rng.choice(M, n_src, replace=False)
    feat_desc = proj_desc[src] ^ _flips(rng, n_src, 60)
    feat_uv = proj_uv[src] + rng.normal(0.0, 3.0, (n_src, 2))
    feat_level = np.clip(proj_level[src] + rng.integers(-1, 2, n_src), 0,
                         n_levels - 1)
    of = rng.choice(n_src, n_tw, replace=False)
    feat_desc = np.concatenate([feat_desc, feat_desc[of]
                                ^ _flips(rng, n_tw, 30)])
    feat_uv = np.concatenate([feat_uv, feat_uv[of]
                              + rng.normal(0.0, 3.0, (n_tw, 2))]).astype(f32)
    feat_level = np.concatenate([feat_level, feat_level[of]]).astype(np.int32)
    # angles at bin centres: matched pairs differ by 3.5 bins, a fifth by a
    # random number of bins
    bin_w = 2.0 * np.pi / HISTO_BINS
    k_feat = rng.integers(0, HISTO_BINS, N)
    k_proj = rng.integers(0, HISTO_BINS, M)
    shift = np.where(rng.random(n_src) < 0.8, 3,
                     rng.integers(0, HISTO_BINS, n_src))
    k_proj[src] = np.mod(k_feat[:n_src] + shift, HISTO_BINS)
    return dict(proj_uv=proj_uv, proj_valid=rng.random(M) < 0.8,
                proj_level=proj_level, proj_desc=proj_desc,
                feat_uv=feat_uv, feat_level=feat_level, feat_desc=feat_desc,
                feat_valid=rng.random(N) < 0.95,
                proj_angle=((k_proj + 0.5) * bin_w).astype(f32),
                feat_angle=(k_feat * bin_w).astype(f32),
                proj_angle_valid=rng.random(M) < 0.7)


# ---------------------------------------------------------------------------
# the mesh path against one device
# ---------------------------------------------------------------------------

def _mesh_map_system(n_kf, n_pts, obs_per_kf, max_kf, max_mp, n_feat):
    """A VI SlamSystem holding a hand-built map: n_kf keyframes 0.2 m apart
    along x at a constant 0.8 m/s, each observing a sliding block of
    `obs_per_kf` of the n_pts landmarks (so each landmark has several
    observers), with the matching gravity-only IMU chains between them. The
    observations are exact; keyframe positions (all but the first) and
    landmarks start perturbed, so a bundle adjustment has work to do."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mc_slam.camera import make_camera
    from mc_slam.pipeline.system import SlamConfig, SlamSystem

    cam = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
    cfg = SlamConfig(max_kf=max_kf, max_mp=max_mp, n_feat=n_feat, n_levels=3,
                     use_imu=True)
    slam = SlamSystem(cam, cfg)
    rng = np.random.default_rng(0)
    # landmark i sits in front of keyframe (i - obs/2) / stride
    stride = max(1, n_pts // n_kf)
    xs = 0.2 * (np.arange(n_pts) - obs_per_kf / 2) / stride
    pts = np.stack([xs + rng.uniform(-0.1, 0.1, n_pts),
                    rng.uniform(-1.5, 1.5, n_pts),
                    rng.uniform(4.0, 7.0, n_pts)], 1).astype(np.float32)
    raw = np.zeros((50, 7), np.float32)
    raw[:, 5] = 9.81
    raw[:, 6] = 0.005
    pre = slam._preintegrate_raw(raw, jnp.zeros(3), jnp.zeros(3))
    P = np.stack([0.2 * np.arange(n_kf), np.zeros(n_kf), np.zeros(n_kf)],
                 1).astype(np.float32)
    kf_mp = np.full((max_kf, n_feat), -1, np.int32)
    kf_uv = np.zeros((max_kf, n_feat, 2), np.float32)
    for k in range(n_kf):
        idx = (k * stride + np.arange(obs_per_kf)) % n_pts
        Pc = pts[idx] - P[k]
        kf_mp[k, :obs_per_kf] = idx
        kf_uv[k, :obs_per_kf] = np.stack(
            [300.0 * Pc[:, 0] / Pc[:, 2] + 240.0,
             300.0 * Pc[:, 1] / Pc[:, 2] + 180.0], 1)
    # constant 0.8 m/s along x: consistent with the gravity-only IMU rows
    V = np.tile(np.asarray([[0.8, 0.0, 0.0]], np.float32), (n_kf, 1))
    P0 = P + np.r_[np.zeros((1, 3)), rng.normal(0.0, 0.01, (n_kf - 1, 3))]
    X0 = pts + rng.normal(0.0, 0.05, pts.shape)
    m = slam.m
    ks = jnp.arange(n_kf)
    m = m._replace(
        kf_ns=m.kf_ns._replace(P=m.kf_ns.P.at[ks].set(jnp.asarray(P0, jnp.float32)),
                               V=m.kf_ns.V.at[ks].set(jnp.asarray(V))),
        kf_uv=jnp.asarray(kf_uv), kf_mp=jnp.asarray(kf_mp),
        kf_feat_valid=m.kf_feat_valid.at[ks].set(True),
        kf_active=m.kf_active.at[ks].set(True),
        kf_id=m.kf_id.at[ks].set(ks * 5),
        kf_time=m.kf_time.at[ks].set(0.25 * ks),
        kf_preint=jax.tree_util.tree_map(
            lambda a, b: a.at[ks].set(jnp.broadcast_to(b, (n_kf,) + b.shape)),
            m.kf_preint, pre),
        mp_pos=m.mp_pos.at[:n_pts].set(jnp.asarray(X0, jnp.float32)),
        mp_active=m.mp_active.at[:n_pts].set(True))
    slam.m = m
    for k in range(n_kf):
        slam.kf_slots.append(k)
        slam.kf_id_host[k] = k * 5
        slam.kf_time_host[k] = 0.25 * k
    slam.vi_inited = True
    slam.n_kf = n_kf
    slam.last_kf_slot = n_kf - 1
    slam.next_fresh_slot = n_kf
    return slam


def pipeline_mesh_compare(mesh, n_kf, n_pts, obs_per_kf, max_kf, max_mp,
                          n_feat, chunk=1024):
    """The pipeline's distributed entries against its single-device ones on
    the same hand-built map: whole-map GBA (SlamSystem._global_ba_chunked,
    routed through dist_gba by enable_mesh) and the loop essential graph
    (loopclosing.close_loop with the edge mesh). Returns the largest
    position differences and the GBA seconds on 1 and on the mesh's
    devices."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mc_slam.geometry.sim3solver import Sim3Result
    from mc_slam.parallel import dist_ba
    from mc_slam.pipeline import loopclosing

    slam = _mesh_map_system(n_kf, n_pts, obs_per_kf, max_kf, max_mp, n_feat)
    m0 = slam.m
    window = list(slam.kf_slots)
    # loop between the last and the first keyframe: their true relative
    # Sim3 (cameras share one orientation; camera == body) with a 1 cm
    # error for the essential graph to distribute
    res = Sim3Result(ok=True, s=jnp.asarray(1.0), R=jnp.eye(3),
                     t=jnp.asarray([-0.2 * (n_kf - 1), 0.01, 0.0]),
                     inliers=None, n_inliers=n_pts)
    out = {}
    for name, msh in (("1", None), ("n", mesh)):
        slam.m = m0
        slam.mesh = msh
        slam.mesh_e = None if msh is None else dist_ba.make_mesh(
            msh.devices.size, axis="e")
        t0 = time.perf_counter()
        slam._global_ba_chunked(window, prune=False, chunk=chunk)
        jax.block_until_ready(slam.m.mp_pos)
        out["t" + name] = time.perf_counter() - t0
        out["span" + name] = len(slam.m.mp_pos.sharding.device_set)
        out["P" + name] = np.asarray(slam.m.kf_ns.P)
        out["X" + name] = np.asarray(slam.m.mp_pos)
        m2 = loopclosing.close_loop(m0, window, n_kf - 1, 0, res, slam.cam,
                                    fix_scale=True, mesh=slam.mesh_e)
        out["L" + name] = np.asarray(m2.kf_ns.P)
    act = np.asarray(m0.kf_active)
    mpa = np.asarray(m0.mp_active)
    for k in ("P1", "Pn", "X1", "Xn", "L1", "Ln"):
        assert np.all(np.isfinite(out[k])), f"non-finite pipeline {k}"
    moved = float(np.abs(out["X1"] - np.asarray(m0.mp_pos))[mpa].max())
    assert moved > 1e-3, "the GBA left the map unchanged"
    assert out["span1"] == 1 and out["spann"] == mesh.devices.size, out
    return {"moved": moved, "span": out["spann"],
            "dP": float(np.abs(out["Pn"] - out["P1"])[act].max()),
            "dX": float(np.abs(out["Xn"] - out["X1"])[mpa].max()),
            "dP_loop": float(np.abs(out["Ln"] - out["L1"])[act].max()),
            "t1": out["t1"], "tn": out["tn"]}


def posegraph_compare(n_devices, K=512, iters=25):
    """Edge-sharded Sim3 pose-graph LM (dist_posegraph) against the
    single-device optimizer on a K-vertex ring with rotation/scale drift
    and one loop edge. Returns the largest differences, the per-iteration
    seconds on 1 and n devices, and how many devices the edges span."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mc_slam import lie
    from mc_slam.parallel import dist_ba, dist_posegraph
    from mc_slam.solver import posegraph

    ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
    P_gt = np.stack([np.cos(ang), np.sin(ang), np.zeros(K)], 1) * K / 12.0
    R_gt = np.asarray(jax.vmap(lie.so3_exp)(jnp.asarray(
        np.stack([np.zeros(K), np.zeros(K), ang], 1), jnp.float32)))
    Rcw = np.swapaxes(R_gt, 1, 2).astype(np.float32)
    tcw = -np.einsum("kij,kj->ki", Rcw, P_gt).astype(np.float32)
    s_gt = jnp.ones(K, jnp.float32)
    R_v, t_v = jnp.asarray(Rcw), jnp.asarray(tcw)
    ei = jnp.asarray(np.r_[np.arange(K - 1), K - 1], jnp.int32)
    ej = jnp.asarray(np.r_[np.arange(1, K), 0], jnp.int32)
    sm, Rm, tm = posegraph.edge_measurement(
        s_gt[ei], R_v[ei], t_v[ei], s_gt[ej], R_v[ej], t_v[ej])
    rng = np.random.default_rng(0)
    drift = np.asarray(jax.vmap(lie.so3_exp)(jnp.asarray(
        np.stack([np.zeros(K), np.zeros(K), 0.02 * np.arange(K) * 12 / K],
                 1), jnp.float32)))
    t0 = t_v + jnp.asarray(0.03 * rng.normal(size=(K, 3)), jnp.float32)
    g = posegraph.Sim3Graph(
        s=jnp.asarray(1.0 + 0.01 * np.arange(K) * 12 / K, jnp.float32),
        R=jnp.asarray(np.einsum("kij,kjl->kil", Rcw, drift)),
        t=t0.at[0].set(t_v[0]), ei=ei, ej=ej, s_m=sm, R_m=Rm, t_m=tm,
        w=jnp.ones(K, jnp.float32),
        free=jnp.ones(K, jnp.float32).at[0].set(0.0))
    mesh = dist_ba.make_mesh(n_devices, axis="e")
    times = {}
    res = {}
    for name, f in (("1", lambda: posegraph.optimize_pose_graph(
                         g, iters=iters)),
                    ("n", lambda: dist_posegraph.optimize_pose_graph_dist(
                        mesh, g, iters=iters))):
        jax.block_until_ready(f())
        t = time.perf_counter()
        res[name] = jax.block_until_ready(f())
        times[name] = (time.perf_counter() - t) / iters
    (R1, s1, t1, _), (Rn, sn, tn, _) = res["1"], res["n"]
    return {"K": K, "span": len(tn.sharding.device_set),
            "ds": float(jnp.abs(sn - s1).max()),
            "dt": float(jnp.abs(tn - t1).max()),
            "dR": float(jnp.abs(Rn - R1).max()),
            "t1": times["1"], "tn": times["n"]}
