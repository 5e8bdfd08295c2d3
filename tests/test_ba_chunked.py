"""Landmark-chunked global BA: equality vs the dense Schur engine and
convergence at sizes where the dense Wcp would be prohibitive."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.solver import ba, ba_chunked, ba_vi, factors
from mc_slam.imu.preintegration import euroc_noise

from test_solver import CAM, EXT, synth_scene


def _chunk_from_visualobs(obs, Np, n_chunks):
    return ba_chunked.chunk_observations(
        np.asarray(obs.cam), np.asarray(obs.pt), np.asarray(obs.uv),
        np.asarray(obs.inv_sigma2), np.asarray(obs.valid), Np, n_chunks,
        ur=None if obs.ur is None else np.asarray(obs.ur))


def test_chunked_equals_dense_visual(rng):
    pts, P, R, obs = synth_scene(rng, Nc=6, Np=80, noise_px=0.5)
    Np = 80
    free = jnp.ones(6, jnp.float32).at[0].set(0.0)
    pt_mask = jnp.ones(Np, jnp.float32)
    dP = rng.normal(size=(6, 3)).astype(np.float32) * 0.05
    dP[0] = 0
    P0 = jnp.asarray(P + dP)
    R0 = jnp.asarray(R)
    pts0 = jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05)

    Pd, Rd, ptsd, chi2, cost_d = ba.visual_ba(P0, R0, pts0, obs, CAM, EXT,
                                              free, pt_mask, iters=8)
    cobs, C = _chunk_from_visualobs(obs, Np, 4)
    Pc, Rc, ptsc, cost_c = ba_chunked.visual_gba_chunked(
        P0, R0, pts0, cobs, CAM, EXT, free, pt_mask, iters=8)
    # same LM schedule + same math => same optimum within f32 reduction noise
    np.testing.assert_allclose(np.asarray(Pc), np.asarray(Pd), atol=2e-3)
    np.testing.assert_allclose(np.asarray(ptsc), np.asarray(ptsd), atol=5e-3)


def test_chunked_converges_and_reduces_error(rng):
    pts, P, R, obs = synth_scene(rng, Nc=8, Np=160, noise_px=0.3)
    Np = 160
    free = jnp.ones(8, jnp.float32).at[0].set(0.0).at[1].set(0.0)
    pt_mask = jnp.ones(Np, jnp.float32)
    dP = rng.normal(size=(8, 3)).astype(np.float32) * 0.08
    dP[:2] = 0
    P0 = jnp.asarray(P + dP)
    cobs, C = _chunk_from_visualobs(obs, Np, 8)
    Pc, Rc, ptsc, cost = ba_chunked.visual_gba_chunked(
        P0, jnp.asarray(R), jnp.asarray(pts), cobs, CAM, EXT, free, pt_mask,
        iters=12)
    err0 = np.abs(np.asarray(P0) - P).max()
    err = np.abs(np.asarray(Pc) - P).max()
    assert err < 0.3 * err0, (err0, err)


def test_chunked_vi_gba(rng):
    """VI chunked GBA against the dense vi_ba on the same window."""
    from test_vi_solver import GW, build_vi_window, kfs_to_navstate
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=6, noise_px=0.3)
    N = 6
    Np = pts.shape[0]
    # pad landmarks to a multiple of 4 chunks
    Npad = int(np.ceil(Np / 4)) * 4
    pts_p = np.zeros((Npad, 3), np.float32)
    pts_p[:Np] = pts
    ns_true = kfs_to_navstate(kfs)
    edges = ba_vi.IMUEdges(
        i=jnp.arange(0, N - 1, dtype=jnp.int32),
        j=jnp.arange(1, N, dtype=jnp.int32),
        pre=jax.tree_util.tree_map(lambda a: a[1:], pre),
        info_prv=factors.imu_prv_info(jax.tree_util.tree_map(lambda a: a[1:], pre)),
        info_bias=factors.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
        valid=jnp.ones(N - 1, jnp.float32))
    free = jnp.asarray([0.0, 0.0] + [1.0] * (N - 2), jnp.float32)
    pt_mask = jnp.asarray((np.arange(Npad) < Np).astype(np.float32))

    dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
    dP[:2] = 0
    ns0 = ns_true._replace(P=ns_true.P + dP)

    ns_d, pts_d, chi2, cost_d = ba_vi.vi_ba(
        ns0, jnp.asarray(pts_p), obs, edges, CAM, EXT, GW, free, pt_mask, iters=8)
    cobs, C = ba_chunked.chunk_observations(
        np.asarray(obs.cam), np.asarray(obs.pt), np.asarray(obs.uv),
        np.asarray(obs.inv_sigma2), np.asarray(obs.valid), Npad, 4)
    ns_c, pts_c, cost_c = ba_chunked.vi_gba_chunked(
        ns0, jnp.asarray(pts_p), cobs, edges, CAM, EXT, GW, free, pt_mask,
        iters=8)
    np.testing.assert_allclose(np.asarray(ns_c.P), np.asarray(ns_d.P), atol=3e-3)
    np.testing.assert_allclose(np.asarray(ns_c.V), np.asarray(ns_d.V), atol=2e-2)
    p_err0 = np.abs(np.asarray(ns0.P) - np.asarray(ns_true.P)).max()
    p_err = np.abs(np.asarray(ns_c.P) - np.asarray(ns_true.P)).max()
    assert p_err < 0.3 * p_err0, (p_err0, p_err)


def test_chunked_vi_gba_sharded_equals_single(rng):
    """Mesh-sharded chunked VI GBA == single-device chunked VI GBA (same
    ChunkedObs layout, 8 chunks over an 8-device mesh)."""
    from test_vi_solver import GW, build_vi_window, kfs_to_navstate
    from mc_slam.parallel import dist_ba, dist_gba
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=6, noise_px=0.3)
    N = 6
    Np = pts.shape[0]
    Npad = int(np.ceil(Np / 8)) * 8
    pts_p = np.zeros((Npad, 3), np.float32)
    pts_p[:Np] = pts
    ns_true = kfs_to_navstate(kfs)
    edges = ba_vi.IMUEdges(
        i=jnp.arange(0, N - 1, dtype=jnp.int32),
        j=jnp.arange(1, N, dtype=jnp.int32),
        pre=jax.tree_util.tree_map(lambda a: a[1:], pre),
        info_prv=factors.imu_prv_info(jax.tree_util.tree_map(lambda a: a[1:], pre)),
        info_bias=factors.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
        valid=jnp.ones(N - 1, jnp.float32))
    free = jnp.asarray([0.0, 0.0] + [1.0] * (N - 2), jnp.float32)
    pt_mask = jnp.asarray((np.arange(Npad) < Np).astype(np.float32))
    dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
    dP[:2] = 0
    ns0 = ns_true._replace(P=ns_true.P + dP)

    cobs, C = ba_chunked.chunk_observations(
        np.asarray(obs.cam), np.asarray(obs.pt), np.asarray(obs.uv),
        np.asarray(obs.inv_sigma2), np.asarray(obs.valid), Npad, 8)
    ns_1, pts_1, cost_1 = ba_chunked.vi_gba_chunked(
        ns0, jnp.asarray(pts_p), cobs, edges, CAM, EXT, GW, free, pt_mask,
        iters=8)

    mesh = dist_ba.make_mesh(8)
    cobs_s = dist_gba.shard_chunked_obs(mesh, cobs)
    ns_s, pts_s, cost_s = dist_gba.vi_gba_chunked_sharded(
        mesh, ns0, jnp.asarray(pts_p), cobs_s, edges, CAM, EXT, GW, free,
        pt_mask, iters=8)
    np.testing.assert_allclose(np.asarray(ns_s.P), np.asarray(ns_1.P), atol=2e-4)
    np.testing.assert_allclose(np.asarray(ns_s.V), np.asarray(ns_1.V), atol=2e-3)
    # landmarks: 1e-2, not 1e-3 — a 2-observation landmark in this problem
    # legitimately slides ~1.8 units along its depth near-nullspace during
    # the solve, and f32 psum reduction order steers that unobservable
    # direction by a few 1e-3 (costs still match to 1e-6 relative; poses to
    # 2e-4). Equality on well-conditioned state is the real contract.
    np.testing.assert_allclose(np.asarray(pts_s), np.asarray(pts_1), atol=1e-2)
    np.testing.assert_allclose(float(cost_s), float(cost_1), rtol=1e-4)
