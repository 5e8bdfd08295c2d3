"""Representative synthetic problems for benchmarking and compile checks.

Shared by bench.py, chip_smoke.py, examples/bench_scaling.py and
__graft_entry__.py: EuRoC-scale local-window and whole-map VI BA workloads
built from deterministic numpy (no dataset needed).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import euroc_camera
from mc_slam.imu.navstate import NavState
from mc_slam.imu.preintegration import euroc_noise, preintegrate
from mc_slam.solver import ba_vi, factors
from mc_slam.solver.ba import VisualObs


def vi_window_problem(n_kf=20, n_pts=2048, obs_per_kf=512, seed=0,
                      dtype=jnp.float32):
    """EuRoC-scale sliding-window VI BA problem (LocalWindowSize 20,
    config/euroc.yaml:47; ~1000 features/frame)."""
    rng = np.random.default_rng(seed)
    cam = euroc_camera()
    ext = factors.identity_extrinsics()
    gw = jnp.asarray([0.0, 0.0, -9.81], dtype)

    pts = np.stack([rng.uniform(-6, 6, n_pts), rng.uniform(-4, 4, n_pts),
                    rng.uniform(4, 12, n_pts)], 1).astype(np.float32)
    P = np.stack([np.linspace(-2, 2, n_kf), 0.1 * rng.normal(size=n_kf),
                  0.05 * rng.normal(size=n_kf)], 1).astype(np.float32)
    phis = (rng.normal(size=(n_kf, 3)) * 0.05).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray(phis)))
    V = np.gradient(P, axis=0) / 0.25

    z3 = jnp.zeros((n_kf, 3), dtype)
    ns = NavState(P=jnp.asarray(P), V=jnp.asarray(V, dtype), R=jnp.asarray(R),
                  bg=z3, ba=z3, dbg=z3, dba=z3)

    # observations: obs_per_kf random points per keyframe with noisy projections
    O = n_kf * obs_per_kf
    cam_i = np.repeat(np.arange(n_kf), obs_per_kf).astype(np.int32)
    pt_i = rng.integers(0, n_pts, size=O).astype(np.int32)
    Pc = np.einsum('oij,oj->oi', np.swapaxes(R[cam_i], 1, 2), pts[pt_i] - P[cam_i])
    z = np.maximum(Pc[:, 2], 0.5)
    uv = np.stack([458.654 * Pc[:, 0] / z + 367.215,
                   457.296 * Pc[:, 1] / z + 248.375], 1)
    uv += rng.normal(size=uv.shape) * 0.7
    obs = VisualObs(cam=jnp.asarray(cam_i), pt=jnp.asarray(pt_i),
                    uv=jnp.asarray(uv, dtype),
                    inv_sigma2=jnp.ones(O, dtype),
                    valid=jnp.asarray(Pc[:, 2] > 0.5, dtype))

    # IMU chain: 50 samples per gap at 200 Hz — ONE vmapped preintegration
    # over the gaps (a python loop of eager calls compiles and dispatches
    # once per gap)
    noise = euroc_noise()
    rows = np.zeros((n_kf - 1, 50, 7), np.float32)
    rows[..., 0:3] = rng.normal(size=(n_kf - 1, 50, 3)) * 0.2
    rows[..., 3:6] = rng.normal(size=(n_kf - 1, 50, 3)) * 0.5 + [0, 0, 9.81]
    rows[..., 6] = 0.005
    z3s = jnp.zeros((n_kf - 1, 3), dtype)
    pre = jax.vmap(lambda r, bg, ba: preintegrate(r, bg, ba, noise))(
        jnp.asarray(rows), z3s, z3s)
    edges = ba_vi.IMUEdges(
        i=jnp.arange(0, n_kf - 1, dtype=jnp.int32),
        j=jnp.arange(1, n_kf, dtype=jnp.int32),
        pre=pre, info_prv=factors.imu_prv_info(pre),
        info_bias=factors.bias_rw_info(pre.dT, 2e-5, 5e-3),
        valid=jnp.ones(n_kf - 1, dtype))

    free = jnp.ones(n_kf, dtype).at[0].set(0.0)
    pt_mask = jnp.ones(n_pts, dtype)
    return dict(ns=ns, pts=jnp.asarray(pts), obs=obs, edges=edges, cam=cam,
                ext=ext, gw=gw, free=free, pt_mask=pt_mask)


def vi_window_idp_problem(n_kf=20, n_pts=2048, obs_per_kf=512, seed=0,
                          dtype=jnp.float32):
    """The same window as vi_window_problem in the pipeline's anchored
    inverse-depth form (LocalBAPRVIDP parity): each landmark anchored to its
    first observing keyframe."""
    from mc_slam.solver import ba_vi_idp
    p = vi_window_problem(n_kf, n_pts, obs_per_kf, seed, dtype)
    obs = p["obs"]
    cam_i = np.asarray(obs.cam)
    pt_i = np.asarray(obs.pt)
    uv = np.asarray(obs.uv)
    anchor = np.full(n_pts, -1, np.int32)
    uv0 = np.zeros((n_pts, 2), np.float32)
    for o in np.argsort(cam_i, kind="stable"):
        if anchor[pt_i[o]] < 0:
            anchor[pt_i[o]] = cam_i[o]
            uv0[pt_i[o]] = uv[o]
    used = anchor >= 0
    anc = np.clip(anchor, 0, n_kf - 1)
    rho = np.asarray(ba_vi_idp.xyz_to_idp(
        p["pts"], p["ns"].P[jnp.asarray(anc)], p["ns"].R[jnp.asarray(anc)],
        jnp.asarray(uv0), p["cam"], p["ext"]))
    keep = used[pt_i] & (cam_i != anchor[pt_i])
    idp_obs = ba_vi_idp.IDPObs(
        anchor=jnp.asarray(anc[pt_i], jnp.int32),
        obs_kf=jnp.asarray(cam_i, jnp.int32),
        pt=jnp.asarray(pt_i, jnp.int32),
        uv0=jnp.asarray(uv0[pt_i]),
        uv=jnp.asarray(uv, dtype),
        inv_sigma2=jnp.ones(len(pt_i), dtype),
        valid=jnp.asarray(keep, dtype))
    return dict(p, idp_obs=idp_obs,
                rho=jnp.asarray(np.where(used, rho, 0.1), dtype),
                rho_mask=jnp.asarray(used, dtype))


def gba_map_problem(n_kf=128, n_pts=12288, obs_per_kf=400, n_chunks=96,
                    seed=0):
    """Whole-map VI GBA at euroc-map scale (128 KF / 12k points / ~50k
    observations), landmark-chunked for ba_chunked.vi_gba_chunked and its
    mesh-sharded twin dist_gba.vi_gba_chunked_sharded. Returns (ns, pts,
    cobs, edges, cam, ext, gw, free, pt_mask, meta)."""
    from mc_slam.solver import ba_chunked
    p = vi_window_problem(n_kf=n_kf, n_pts=n_pts, obs_per_kf=obs_per_kf,
                          seed=seed)
    obs = p["obs"]
    cobs, _ = ba_chunked.chunk_observations(
        np.asarray(obs.cam), np.asarray(obs.pt), np.asarray(obs.uv),
        np.asarray(obs.inv_sigma2), np.asarray(obs.valid), n_pts, n_chunks)
    meta = {"source": "synthetic", "n_kf": n_kf, "n_pts": n_pts,
            "n_obs": int(np.asarray(obs.valid).sum()), "chunks": n_chunks}
    return (p["ns"], p["pts"], cobs, p["edges"], p["cam"], p["ext"],
            p["gw"], p["free"], p["pt_mask"], meta)
