"""Mesh-sharded landmark-chunked whole-map bundle adjustment.

Combines solver/ba_chunked.py (O(map) landmark-chunked Schur, the scalable
form of the reference's GlobalBundleAdjustmentNavStatePRV,
src/Optimizer.cpp:629) with parallel/dist_ba.py's landmark sharding: the
CHUNK axis of ChunkedObs is distributed over a 1-D device mesh, every device
scan-reduces its own chunks into a partial Schur-reduced camera system, ONE
`psum` per linearization moves the dense (Nc*DC)^2 reduced system between devices,
the small replicated Cholesky solves it everywhere, and landmark
back-substitution stays shard-local (an `all_gather` of the tiny (Np,3)
update keeps the LM state replicated).

Communication per LM iteration: psum of Nc*DC*(Nc*DC+1) floats + all_gather
of Np*3 floats — both independent of the observation count, which is where
the FLOPs live. Chunks <-> shards is exactly the correspondence promised in
ba_chunked.py's header; the same ChunkedObs layout serves both.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mc_slam import lie
from mc_slam.solver import ba_chunked as bc
from mc_slam.solver import lm
from mc_slam.solver.ba_vi import (DC as DC_VI, IMUEdges, _imu_edge_factors,
                                      retract_states)


def shard_chunked_obs(mesh, cobs: bc.ChunkedObs, axis="mp"):
    """Place a ChunkedObs on the mesh, sharded by the leading (chunk) axis.
    The chunk count must divide by the mesh size (pad with empty chunks)."""
    spec = NamedSharding(mesh, P(axis))
    put = lambda x: None if x is None else jax.device_put(x, spec)
    return bc.ChunkedObs(cam=put(cobs.cam), pt=put(cobs.pt), uv=put(cobs.uv),
                         inv_sigma2=put(cobs.inv_sigma2),
                         valid=put(cobs.valid), ur=put(cobs.ur))


def vi_gba_chunked_sharded(mesh, ns0, pts0, cobs: bc.ChunkedObs,
                           edges: IMUEdges, camera, ext, gw, free_cam,
                           pt_mask, iters: int = 10, lam0: float = 1e-4,
                           bf=0.0, axis="mp"):
    """Mesh-distributed vi_gba_chunked. Bit-compatible problem layout with the
    single-device version (same ChunkedObs); equality is tested to f32
    reduction-order tolerance in tests/test_parallel.py."""
    n_dev = mesh.devices.size
    S = cobs.cam.shape[0]
    assert S % n_dev == 0, (S, n_dev)
    Nc, DC = ns0.P.shape[0], DC_VI
    Np = pts0.shape[0]
    C = Np // S
    ks_global = jax.device_put(jnp.arange(S, dtype=jnp.int32),
                               NamedSharding(mesh, P(axis)))
    spec_obs = jax.tree_util.tree_map(lambda _: P(axis), cobs)
    rep = lambda t: jax.tree_util.tree_map(lambda _: P(), t)

    def cam_factor_system(ns):
        H = jnp.zeros((Nc, DC, Nc, DC), pts0.dtype)
        g = jnp.zeros((Nc, DC), pts0.dtype)
        cost = jnp.zeros((), pts0.dtype)
        prv, bias = _imu_edge_factors(ns, edges, gw)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free_cam)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free_cam)
        return H, g, cost

    # check_vma=False: the chunked scans carry unvarying zero-initialized
    # accumulators over shard-varying inputs; the psum at the end makes the
    # outputs genuinely replicated.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_obs, P(axis), rep(ns0), P(), P(), rep(camera),
                       rep(ext), P()),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def reduce_shard(cobs_l, ks_l, ns, pts, lam, cam_l, ext_l, fc):
        get_PR = lambda ci: (ns.P[ci], ns.R[ci])
        S_red, g_red, diag, cost = bc._scan_reduce(
            get_PR, pts, cobs_l, cam_l, ext_l, bf, fc, bc._embed15,
            Nc, DC, C, lam, ks=ks_l)
        return jax.lax.psum((S_red, g_red, diag, cost), axis)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_obs, P(axis), rep(ns0), P(), P(), rep(camera),
                       rep(ext), P(), P(), P()),
             out_specs=P(), check_vma=False)
    def backsub_shard(cobs_l, ks_l, ns, pts, lam, cam_l, ext_l, fc, dxc, ptm):
        get_PR = lambda ci: (ns.P[ci], ns.R[ci])
        dxp_l = bc._scan_backsub(get_PR, pts, cobs_l, cam_l, ext_l, bf, fc,
                                 bc._embed15, Nc, DC, C, lam, dxc, ptm,
                                 ks=ks_l)
        # shards own contiguous chunk ranges, so gathering along the mesh
        # axis reassembles the global landmark order
        dxp_all = jax.lax.all_gather(dxp_l, axis)       # (n_dev, Np/n_dev, 3)
        return dxp_all.reshape(Np, 3)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_obs, P(axis), rep(ns0), P(), rep(camera),
                       rep(ext)),
             out_specs=P(), check_vma=False)
    def cost_shard(cobs_l, ks_l, ns, pts, cam_l, ext_l):
        get_PR = lambda ci: (ns.P[ci], ns.R[ci])
        c = bc._chunk_cost(get_PR, pts, cobs_l, cam_l, ext_l, bf, C, ks=ks_l)
        return jax.lax.psum(c, axis)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_obs, P(axis), rep(ns0), P(), rep(camera),
                       rep(ext)),
             out_specs=P(axis), check_vma=False)
    def classify_shard(cobs_l, ks_l, ns, pts, cam_l, ext_l):
        get_PR = lambda ci: (ns.P[ci], ns.R[ci])
        return bc._chunk_classify(get_PR, pts, cobs_l, cam_l, ext_l, bf, C,
                                  ks=ks_l)

    def retract(x, dx):
        ns, pts = x
        dxc, dxp = dx
        return retract_states(ns, dxc), pts + dxp

    def make_fns(valid):
        vobs = cobs._replace(valid=valid)

        def cost_fn(x):
            ns, pts = x
            c = cost_shard(vobs, ks_global, ns, pts, camera, ext)
            _, _, c_imu = cam_factor_system(ns)
            return c + c_imu

        def linearize_solve(x, lam):
            ns, pts = x
            S_red, g_red, diag, _ = reduce_shard(vobs, ks_global, ns, pts, lam,
                                                 camera, ext, free_cam)
            Hc, gc, _ = cam_factor_system(ns)
            dxc = bc._solve_reduced(S_red, g_red, diag, Hc, gc, lam, free_cam,
                                    Nc, DC)
            dxp = backsub_shard(vobs, ks_global, ns, pts, lam, camera, ext,
                                free_cam, dxc, pt_mask)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        ns, pts = x
        return classify_shard(cobs._replace(valid=valid0), ks_global, ns, pts,
                              camera, ext)

    # same round structure as the single-device vi_gba_chunked (single
    # phase, reference-GBA parity) — required for the equality tests
    run = jax.jit(lambda x0: lm.lm_two_phase(
        x0, make_fns, cobs.valid, classify, iters, lam0=lam0, enable=False))
    (ns, pts), cost, _ = run((ns0, pts0))
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))
    return ns, pts, cost
