"""Landmark-chunked global bundle adjustment — O(map)-scalable Schur.

Replaces the dense-landmark path for whole-map problems (the reference's
GlobalBundleAdjustment / GlobalBundleAdjustmentNavStatePRV,
src/Optimizer.cpp:3346 / :629, called from VI init and loop-closure GBA,
src/LoopClosing.cpp:804-950). The dense engine in lm.py materializes
Wcp (Nc,DC,Np,DP) — at the EuRoC profile (512 KF x 15d x 16k pts x 3d) that is
~1.5 GB per linearization. Here landmarks are processed in fixed-size chunks
with a lax.scan: each chunk builds its local landmark system, Schur-eliminates
it, and accumulates the (small, dense) reduced camera system; back-substitution
re-runs the scan once the camera update is known. Peak memory is
O(Nc^2 DC^2 + chunk), independent of the landmark count.

This is also exactly the single-device form of the mesh-distributed reduction
in parallel/dist_ba.py (chunks <-> shards, scan-accumulate <-> psum), so the
same observation layout serves both.

Observation layout: obs are grouped by landmark chunk (chunk k owns landmarks
[k*C, (k+1)*C)), padded to a fixed per-chunk budget. Build with
`chunk_observations` (host-side, once per GBA call).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.imu.navstate import NavState
from mc_slam.solver import factors, lm
from mc_slam.solver.ba import CHI2_MONO, CHI2_STEREO
from mc_slam.solver.ba_vi import (DC as DC_VI, IMUEdges, _imu_edge_factors,
                                      retract_states)


class ChunkedObs(NamedTuple):
    """(S, Oc)-shaped observation chunks; chunk k references landmarks in
    [k*C, (k+1)*C) only (enforced by masking at build time)."""
    cam: jnp.ndarray         # (S, Oc) int32 camera index
    pt: jnp.ndarray          # (S, Oc) int32 GLOBAL landmark index
    uv: jnp.ndarray          # (S, Oc, 2)
    inv_sigma2: jnp.ndarray  # (S, Oc)
    valid: jnp.ndarray       # (S, Oc)
    ur: jnp.ndarray | None = None   # (S, Oc) stereo rows; None = mono


def chunk_observations(cam, pt, uv, inv_sigma2, valid, Np, n_chunks,
                       ur=None, pad_to=None):
    """Host-side: group a flat observation table by landmark chunk.

    cam/pt/... : numpy arrays (O,). Returns (ChunkedObs, C) with C the
    landmark-chunk size. pad_to: per-chunk obs budget (default: max count
    rounded up to a multiple of 512).
    """
    cam = np.asarray(cam); pt = np.asarray(pt)
    uv = np.asarray(uv); inv_sigma2 = np.asarray(inv_sigma2)
    valid = np.asarray(valid).astype(np.float32)
    assert Np % n_chunks == 0, (Np, n_chunks)
    C = Np // n_chunks
    live = valid > 0
    chunk_of = pt // C
    counts = np.bincount(chunk_of[live], minlength=n_chunks)
    Oc = int(counts.max()) if counts.size else 1
    if pad_to is None:
        Oc = max(512, int(np.ceil(Oc / 512)) * 512)
    else:
        assert pad_to >= Oc, (pad_to, Oc)
        Oc = pad_to
    S = n_chunks
    o_cam = np.zeros((S, Oc), np.int32)
    o_pt = np.zeros((S, Oc), np.int32)
    o_uv = np.zeros((S, Oc, 2), np.float32)
    o_is2 = np.ones((S, Oc), np.float32)
    o_val = np.zeros((S, Oc), np.float32)
    o_ur = np.full((S, Oc), -1.0, np.float32) if ur is not None else None
    for k in range(S):
        sel = live & (chunk_of == k)
        n = int(sel.sum())
        o_cam[k, :n] = cam[sel]
        o_pt[k, :n] = pt[sel]
        o_uv[k, :n] = uv[sel]
        o_is2[k, :n] = inv_sigma2[sel]
        o_val[k, :n] = 1.0
        o_pt[k, n:] = k * C                 # padded rows point into the chunk
        if ur is not None:
            o_ur[k, :n] = np.asarray(ur)[sel]
    return ChunkedObs(
        cam=jnp.asarray(o_cam), pt=jnp.asarray(o_pt), uv=jnp.asarray(o_uv),
        inv_sigma2=jnp.asarray(o_is2), valid=jnp.asarray(o_val),
        ur=jnp.asarray(o_ur) if ur is not None else None), C


def _chunk_reproj(camera, ext, P_wb, R_wb, Pw, uv, ur, bf):
    """Mono/stereo residual rows for one chunk. Returns (r, J_pr, J_pt, z, d2)."""
    if ur is None:
        r, J_pr, J_pt, z = factors.reproj_xyz(camera, ext, P_wb, R_wb, Pw, uv)
        return r, J_pr, J_pt, z, CHI2_MONO
    r, J_pr, J_pt, z = factors.reproj_xyz3(camera, ext, P_wb, R_wb, Pw, uv, ur, bf)
    return r, J_pr, J_pt, z, jnp.where(ur >= 0, CHI2_STEREO, CHI2_MONO)


def _robust_w(r, z, inv_sigma2, valid, d2):
    chi2 = jnp.sum(r * r, axis=-1) * inv_sigma2
    w = inv_sigma2 * lm.trunc_huber_weight(chi2, d2) * valid * (z > 1e-6)
    rho = lm.trunc_huber_cost(chi2, d2)
    # behind-camera = the truncation plateau (see lm.HUBER_TRUNC)
    rho = jnp.where(z > 1e-6, rho,
                    jnp.broadcast_to(lm.trunc_plateau(jnp.asarray(d2)), rho.shape))
    cost = jnp.sum(valid * rho)
    return w, cost


def _scan_reduce(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, free_cam,
                 embed, Nc, DC, C, lam, ks=None):
    """First pass: accumulate the Schur-reduced camera system over chunks.
    get_PR(cam_idx) -> (P_wb, R_wb) per obs. Returns (S_red, g_red, diagHcc, cost).
    ks: optional (S,) GLOBAL chunk ids — a mesh shard passes its own slice so
    pt-to-local-index arithmetic stays correct (parallel/dist_gba.py)."""
    DP = 3

    def body(carry, ch):
        S_acc, g_acc, d_acc, c_acc = carry
        k, o_cam, o_pt, o_uv, o_is2, o_val, o_ur = ch
        P_wb, R_wb = get_PR(o_cam)
        pt_local = o_pt - k * C
        in_chunk = (pt_local >= 0) & (pt_local < C)
        pt_local = jnp.clip(pt_local, 0, C - 1)
        r, J_pr, J_pt, z, d2 = _chunk_reproj(camera, ext, P_wb, R_wb,
                                             pts[o_pt], o_uv, o_ur, bf)
        w, cost = _robust_w(r, z, o_is2, o_val * in_chunk, d2)
        o = lm.Observations(cam=o_cam[:, None], pt=pt_local,
                            Jc=embed(J_pr)[:, None], Jp=J_pt, r=r, w=w)
        Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(
            o, free_cam, Nc, DC, C, DP)
        Hpp_inv = lm.batched_inv_small(lm.damp_point_blocks(Hpp, lam))
        Y = jnp.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)
        S_part = Hcc - jnp.einsum('cipk,djpk->cidj', Y, Wcp)
        g_part = g_c - jnp.einsum('cipk,pk->ci', Y, g_p)
        n = Nc * DC
        d_part = jnp.diagonal(Hcc.reshape(n, n))
        return (S_acc + S_part, g_acc + g_part, d_acc + d_part,
                c_acc + cost), None

    S0 = jnp.zeros((Nc, DC, Nc, DC), pts.dtype)
    g0 = jnp.zeros((Nc, DC), pts.dtype)
    d0 = jnp.zeros((Nc * DC,), pts.dtype)
    if ks is None:
        ks = jnp.arange(cobs.cam.shape[0], dtype=jnp.int32)
    ur_stack = cobs.ur if cobs.ur is not None else jnp.zeros_like(cobs.inv_sigma2) - 1.0
    (S_red, g_red, diag, cost), _ = jax.lax.scan(
        body, (S0, g0, d0, jnp.zeros((), pts.dtype)),
        (ks, cobs.cam, cobs.pt, cobs.uv, cobs.inv_sigma2, cobs.valid, ur_stack))
    return S_red, g_red, diag, cost


def _scan_backsub(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, free_cam,
                  embed, Nc, DC, C, lam, dxc, pt_mask, ks=None):
    """Second pass: per-chunk landmark back-substitution given dxc."""
    DP = 3

    def body(_, ch):
        k, o_cam, o_pt, o_uv, o_is2, o_val, o_ur = ch
        P_wb, R_wb = get_PR(o_cam)
        pt_local = o_pt - k * C
        in_chunk = (pt_local >= 0) & (pt_local < C)
        pt_local = jnp.clip(pt_local, 0, C - 1)
        r, J_pr, J_pt, z, d2 = _chunk_reproj(camera, ext, P_wb, R_wb,
                                             pts[o_pt], o_uv, o_ur, bf)
        w, _ = _robust_w(r, z, o_is2, o_val * in_chunk, d2)
        o = lm.Observations(cam=o_cam[:, None], pt=pt_local,
                            Jc=embed(J_pr)[:, None], Jp=J_pt, r=r, w=w)
        Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(
            o, free_cam, Nc, DC, C, DP)
        Hpp_inv = lm.batched_inv_small(lm.damp_point_blocks(Hpp, lam))
        rhs = g_p + jnp.einsum('cipj,ci->pj', Wcp, dxc)
        dxp = -jnp.einsum('pjk,pk->pj', Hpp_inv, rhs)
        mask_k = jax.lax.dynamic_slice_in_dim(pt_mask, k * C, C)
        return None, dxp * mask_k[:, None]

    if ks is None:
        ks = jnp.arange(cobs.cam.shape[0], dtype=jnp.int32)
    ur_stack = cobs.ur if cobs.ur is not None else jnp.zeros_like(cobs.inv_sigma2) - 1.0
    _, dxp = jax.lax.scan(
        body, None,
        (ks, cobs.cam, cobs.pt, cobs.uv, cobs.inv_sigma2, cobs.valid, ur_stack))
    return dxp.reshape(-1, DP)


def _chunk_cost(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, C, ks=None):
    def body(c_acc, ch):
        k, o_cam, o_pt, o_uv, o_is2, o_val, o_ur = ch
        P_wb, R_wb = get_PR(o_cam)
        pt_local = o_pt - k * C
        in_chunk = (pt_local >= 0) & (pt_local < C)
        r, _, _, z, d2 = _chunk_reproj(camera, ext, P_wb, R_wb,
                                       pts[o_pt], o_uv, o_ur, bf)
        _, cost = _robust_w(r, z, o_is2, o_val * in_chunk, d2)
        return c_acc + cost, None

    if ks is None:
        ks = jnp.arange(cobs.cam.shape[0], dtype=jnp.int32)
    ur_stack = cobs.ur if cobs.ur is not None else jnp.zeros_like(cobs.inv_sigma2) - 1.0
    c, _ = jax.lax.scan(
        body, jnp.zeros((), pts.dtype),
        (ks, cobs.cam, cobs.pt, cobs.uv, cobs.inv_sigma2, cobs.valid, ur_stack))
    return c


def _chunk_classify(get_PR, pts, cobs: ChunkedObs, camera, ext, bf, C, ks=None):
    """Per-observation inlier re-classification at the current state:
    valid * (chi2 <= knee) * (z > 0), chunk by chunk — the between-rounds
    outlier gate of the reference (src/Optimizer.cpp:1920-1980)."""
    def body(_, ch):
        k, o_cam, o_pt, o_uv, o_is2, o_val, o_ur = ch
        P_wb, R_wb = get_PR(o_cam)
        r, _, _, z, d2 = _chunk_reproj(camera, ext, P_wb, R_wb,
                                       pts[o_pt], o_uv, o_ur, bf)
        chi2 = jnp.sum(r * r, axis=-1) * o_is2
        return None, o_val * ((chi2 <= d2) & (z > 1e-6)).astype(o_val.dtype)

    if ks is None:
        ks = jnp.arange(cobs.cam.shape[0], dtype=jnp.int32)
    ur_stack = cobs.ur if cobs.ur is not None else jnp.zeros_like(cobs.inv_sigma2) - 1.0
    _, valid2 = jax.lax.scan(
        body, None,
        (ks, cobs.cam, cobs.pt, cobs.uv, cobs.inv_sigma2, cobs.valid, ur_stack))
    return valid2


def _solve_reduced(S_red, g_red, diag, cam_H, cam_g, lam, free_cam, Nc, DC):
    n = Nc * DC
    Sf = (S_red + cam_H).reshape(n, n)
    d = diag + jnp.diagonal(cam_H.reshape(n, n))
    Sf = Sf + jnp.diag(lam * d + 1e-10)
    fm = jnp.repeat(free_cam, DC)
    Sf = Sf * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    L, low = jax.scipy.linalg.cho_factor(Sf, lower=True)
    gf = (g_red + cam_g).reshape(n) * fm
    return jax.scipy.linalg.cho_solve((L, low), -gf).reshape(Nc, DC)


@partial(jax.jit, static_argnames=("iters",))
def visual_gba_chunked(P0, R0, pts0, cobs: ChunkedObs, camera: Camera,
                       ext: factors.Extrinsics, free_cam, pt_mask,
                       iters: int = 10, lam0: float = 1e-4, bf=0.0):
    """Whole-map visual BA (GlobalBundleAdjustment, src/Optimizer.cpp:3346)
    with landmark-chunked Schur. Returns (P, R, pts, cost)."""
    Nc = P0.shape[0]
    DC = 6
    Np = pts0.shape[0]
    C = Np // cobs.cam.shape[0]
    embed = lambda J: J

    def retract(x, dx):
        P, R, pts = x
        dxc, dxp = dx
        return (P + dxc[:, :3], R @ lie.so3_exp(dxc[:, 3:6]), pts + dxp)

    def make_fns(valid):
        vobs = cobs._replace(valid=valid)

        def cost_fn(x):
            P, R, pts = x
            get_PR = lambda ci: (P[ci], R[ci])
            return _chunk_cost(get_PR, pts, vobs, camera, ext, bf, C)

        def linearize_solve(x, lam):
            P, R, pts = x
            get_PR = lambda ci: (P[ci], R[ci])
            S_red, g_red, diag, _ = _scan_reduce(
                get_PR, pts, vobs, camera, ext, bf, free_cam, embed, Nc, DC,
                C, lam)
            Z = jnp.zeros((Nc, DC, Nc, DC), pts.dtype)
            z = jnp.zeros((Nc, DC), pts.dtype)
            dxc = _solve_reduced(S_red, g_red, diag, Z, z, lam, free_cam, Nc, DC)
            dxp = _scan_backsub(get_PR, pts, vobs, camera, ext, bf, free_cam,
                                embed, Nc, DC, C, lam, dxc, pt_mask)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        P, R, pts = x
        get_PR = lambda ci: (P[ci], R[ci])
        return _chunk_classify(get_PR, pts, cobs._replace(valid=valid0),
                               camera, ext, bf, C)

    # single-phase like the reference's global BA (no outlier round,
    # src/Optimizer.cpp:3346) — classify stays available via lm_two_phase
    # for callers that want it
    (P, R, pts), cost, _ = lm.lm_two_phase(
        (P0, R0, pts0), make_fns, cobs.valid, classify, iters, lam0=lam0,
        enable=False)
    return P, lie.so3_normalize_fast(R), pts, cost


def _embed15(J_pr):
    pad = jnp.zeros(J_pr.shape[:-1] + (9,), J_pr.dtype)
    return jnp.concatenate([J_pr, pad], axis=-1)


@partial(jax.jit, static_argnames=("iters",))
def vi_gba_chunked(ns0: NavState, pts0, cobs: ChunkedObs, edges: IMUEdges,
                   camera: Camera, ext: factors.Extrinsics, gw, free_cam,
                   pt_mask, iters: int = 10, lam0: float = 1e-4, bf=0.0):
    """Whole-map VI BA (GlobalBundleAdjustmentNavStatePRV,
    src/Optimizer.cpp:629) with landmark-chunked Schur. Returns (ns, pts, cost)."""
    Nc = ns0.P.shape[0]
    DC = DC_VI
    Np = pts0.shape[0]
    C = Np // cobs.cam.shape[0]

    def cam_factor_system(ns):
        H = jnp.zeros((Nc, DC, Nc, DC), pts0.dtype)
        g = jnp.zeros((Nc, DC), pts0.dtype)
        cost = jnp.zeros((), pts0.dtype)
        prv, bias = _imu_edge_factors(ns, edges, gw)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, prv, free_cam)
        H, g, cost = lm.accumulate_cam_factors(H, g, cost, bias, free_cam)
        return H, g, cost

    def retract(x, dx):
        ns, pts = x
        dxc, dxp = dx
        return retract_states(ns, dxc), pts + dxp

    def make_fns(valid):
        vobs = cobs._replace(valid=valid)

        def cost_fn(x):
            ns, pts = x
            get_PR = lambda ci: (ns.P[ci], ns.R[ci])
            c = _chunk_cost(get_PR, pts, vobs, camera, ext, bf, C)
            _, _, c_imu = cam_factor_system(ns)
            return c + c_imu

        def linearize_solve(x, lam):
            ns, pts = x
            get_PR = lambda ci: (ns.P[ci], ns.R[ci])
            S_red, g_red, diag, _ = _scan_reduce(
                get_PR, pts, vobs, camera, ext, bf, free_cam, _embed15,
                Nc, DC, C, lam)
            Hc, gc, _ = cam_factor_system(ns)
            dxc = _solve_reduced(S_red, g_red, diag, Hc, gc, lam, free_cam,
                                 Nc, DC)
            dxp = _scan_backsub(get_PR, pts, vobs, camera, ext, bf, free_cam,
                                _embed15, Nc, DC, C, lam, dxc, pt_mask)
            return dxc, dxp

        return linearize_solve, retract, cost_fn

    def classify(x, valid0):
        ns, pts = x
        get_PR = lambda ci: (ns.P[ci], ns.R[ci])
        return _chunk_classify(get_PR, pts, cobs._replace(valid=valid0),
                               camera, ext, bf, C)

    # single-phase like the reference's global VI BA (src/Optimizer.cpp:629)
    (ns, pts), cost, _ = lm.lm_two_phase(
        (ns0, pts0), make_fns, cobs.valid, classify, iters, lam0=lam0,
        enable=False)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))
    return ns, pts, cost
