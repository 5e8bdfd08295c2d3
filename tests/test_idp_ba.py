"""Anchored inverse-depth VI window BA (LocalBAPRVIDP parity)."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.solver import ba_vi, factors
from mc_slam.solver.ba_vi_idp import IDPObs, idp_to_xyz, vi_ba_idp, xyz_to_idp

from test_vi_solver import CAM, EXT, GW, build_vi_window, kfs_to_navstate


def _to_idp_problem(kfs, pts, obs):
    """Re-anchor each landmark to its FIRST observing keyframe."""
    N = len(kfs)
    Np = pts.shape[0]
    cam_np = np.asarray(obs.cam)
    pt_np = np.asarray(obs.pt)
    uv_np = np.asarray(obs.uv)
    anchor = np.full(Np, -1, np.int32)
    uv0 = np.zeros((Np, 2), np.float32)
    for o in np.argsort(cam_np, kind="stable"):
        p = pt_np[o]
        if anchor[p] < 0:
            anchor[p] = cam_np[o]
            uv0[p] = uv_np[o]
    used = anchor >= 0
    ns = kfs_to_navstate(kfs)
    rho = np.asarray(xyz_to_idp(jnp.asarray(pts), ns.P[jnp.asarray(np.clip(anchor, 0, N - 1))],
                                ns.R[jnp.asarray(np.clip(anchor, 0, N - 1))],
                                jnp.asarray(uv0), CAM, EXT))
    # observations exclude the anchoring observation itself (zero residual, zero
    # rho-Jacobian) — the reference's EdgePRIDP also links anchor!=observer
    keep = used[pt_np] & (cam_np != anchor[pt_np])
    idp_obs = IDPObs(
        anchor=jnp.asarray(anchor[pt_np], jnp.int32),
        obs_kf=jnp.asarray(cam_np, jnp.int32),
        pt=jnp.asarray(pt_np, jnp.int32),
        uv0=jnp.asarray(uv0[pt_np]),
        uv=jnp.asarray(uv_np, jnp.float32),
        inv_sigma2=jnp.ones(len(pt_np), jnp.float32),
        valid=jnp.asarray(keep, jnp.float32))
    return idp_obs, jnp.asarray(np.where(used, rho, 0.1), jnp.float32), \
        jnp.asarray(anchor), jnp.asarray(uv0), jnp.asarray(used)


def test_idp_window_ba_recovers_perturbation(rng):
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=8, noise_px=0.3)
    N = 8
    ns_true = kfs_to_navstate(kfs)
    idp_obs, rho_true, anchor, uv0, used = _to_idp_problem(kfs, pts, obs)

    dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.04
    dphi = rng.normal(size=(N, 3)).astype(np.float32) * 0.015
    dV = rng.normal(size=(N, 3)).astype(np.float32) * 0.04
    dP[:2] = 0; dphi[:2] = 0; dV[:2] = 0
    ns0 = ns_true._replace(
        P=ns_true.P + dP, V=ns_true.V + dV,
        R=ns_true.R @ lie.so3_exp(jnp.asarray(dphi)))
    rho0 = rho_true * jnp.asarray(
        1.0 + rng.normal(size=rho_true.shape).astype(np.float32) * 0.05)

    edges = ba_vi.IMUEdges(
        i=jnp.arange(0, N - 1, dtype=jnp.int32),
        j=jnp.arange(1, N, dtype=jnp.int32),
        pre=jax.tree_util.tree_map(lambda a: a[1:], pre),
        info_prv=factors.imu_prv_info(jax.tree_util.tree_map(lambda a: a[1:], pre)),
        info_bias=factors.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
        valid=jnp.ones(N - 1, jnp.float32))
    free = jnp.asarray([0.0, 0.0] + [1.0] * (N - 2), jnp.float32)

    ns, rho, chi2, cost = vi_ba_idp(
        ns0, rho0, idp_obs, edges, CAM, EXT, GW, free,
        used.astype(jnp.float32), iters=12)

    p_err0 = np.abs(np.asarray(ns0.P) - np.asarray(ns_true.P)).max()
    p_err = np.abs(np.asarray(ns.P) - np.asarray(ns_true.P)).max()
    assert p_err < 0.25 * p_err0, (p_err0, p_err)
    # landmarks: compare recovered world positions (anchor poses optimized too)
    Xw = np.asarray(idp_to_xyz(rho, uv0, ns.P[anchor], ns.R[anchor], CAM, EXT))
    err = np.linalg.norm(Xw[np.asarray(used)] - pts[np.asarray(used)], axis=1)
    assert np.median(err) < 0.05, np.median(err)


def test_idp_xyz_roundtrip(rng):
    kfs, pre, pts, obs = build_vi_window(rng, N_kf=4, noise_px=0.0)
    ns = kfs_to_navstate(kfs)
    idp_obs, rho, anchor, uv0, used = _to_idp_problem(kfs, pts, obs)
    Xw = np.asarray(idp_to_xyz(rho, uv0, ns.P[anchor], ns.R[anchor], CAM, EXT))
    sel = np.asarray(used)
    np.testing.assert_allclose(Xw[sel], pts[sel], atol=0.02)
