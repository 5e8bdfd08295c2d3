"""Anchored inverse-depth VI window BA — LocalBAPRVIDP parity.

The reference's flagship back-end optimizer (Optimizer::LocalBAPRVIDP,
src/Optimizer.cpp:32): landmarks are 1-D inverse depths anchored to the pixel
ray of their reference keyframe (VertexIDP + EdgePRIDP, 4-vertex edges:
idp/anchor-PR/observer-PR/extrinsic). Here the extrinsic stays fixed (as the
reference effectively does via its huge prior) and each observation carries two
15-D camera blocks (anchor + observer) plus a 1-D landmark block — the generic
Schur engine (lm.build_landmark_system with K=2, DP=1) handles the rest.

Versus the XYZ form (`ba_vi.vi_ba`), inverse depth parameterizes distant points
better and shrinks the landmark system 3x.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.imu.navstate import NavState
from mc_slam.slam_map.mapstate import scatter_slots
from mc_slam.solver import factors, lm
from mc_slam.solver.ba import CHI2_MONO
from mc_slam.solver.ba_vi import (DC, IMUEdges, PriorFactor,
                                      _imu_edge_factors, _prior_factor,
                                      retract_states)


class IDPObs(NamedTuple):
    """Padded anchored-inverse-depth observation table."""
    anchor: jnp.ndarray     # (O,) int32 anchor keyframe (local index)
    obs_kf: jnp.ndarray     # (O,) int32 observing keyframe (local index)
    pt: jnp.ndarray         # (O,) int32 landmark index (into rho)
    uv0: jnp.ndarray        # (O, 2) anchor-frame ideal pixel of the landmark
    uv: jnp.ndarray         # (O, 2) observed ideal pixel
    inv_sigma2: jnp.ndarray  # (O,)
    valid: jnp.ndarray      # (O,)


def _embed15(J6, cols=slice(0, 6)):
    pad = jnp.zeros(J6.shape[:-1] + (9,), J6.dtype)
    return jnp.concatenate([J6, pad], axis=-1)


@partial(jax.jit, static_argnames=("iters", "rtol", "two_phase"))
def vi_ba_idp(ns0: NavState, rho0, obs: IDPObs, edges: IMUEdges, camera: Camera,
              ext: factors.Extrinsics, gw, free_cam, pt_mask, iters: int = 10,
              huber_delta2: float = CHI2_MONO, lam0: float = 1e-4,
              rtol: float = 0.0, prior: PriorFactor | None = None,
              two_phase: bool = True):
    """Windowed VI BA over NavStates + anchored inverse depths.

    ns0: (Nc,...) NavStates; rho0 (Np,) inverse depths; obs references local
    keyframe indices. prior: optional 15-d prior on one keyframe (same role as
    in vi_ba — e.g. the bias anchor of a chain-break window front).
    Returns (ns, rho, chi2 (O,), cost)."""
    Nc = ns0.P.shape[0]
    Np = rho0.shape[0]
    DP = 1

    def per_obs(ns, rho):
        return factors.reproj_idp(
            camera, ext, rho[obs.pt], obs.uv0,
            ns.P[obs.anchor], ns.R[obs.anchor],
            ns.P[obs.obs_kf], ns.R[obs.obs_kf], obs.uv)

    def retract(x, dx):
        ns, rho = x
        dxc, drho = dx
        # the reference clamps inverse depth at 1e-6 (VertexIDP, g2otypes.h:40)
        return retract_states(ns, dxc), jnp.maximum(rho + drho, 1e-6)

    def make_fns(valid):
        def linearize(x):
            """ONE residual/Jacobian pass -> (normal-equation blocks, robust
            cost). The fused LM driver reuses it for both the step and the
            accept/reject decision (lm.lm_optimize_fused)."""
            ns, rho = x
            with jax.named_scope("idp_reproj"):
                r, J_rho, J_pr0, J_pri, z = per_obs(ns, rho)
            chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
            w = obs.inv_sigma2 * lm.trunc_huber_weight(chi2, huber_delta2) \
                * valid * (z > 1e-6)
            rr = lm.trunc_huber_cost(chi2, huber_delta2)
            rr = jnp.where(z > 1e-6, rr, lm.trunc_plateau(huber_delta2))
            cost = jnp.sum(valid * rr)
            # 6-d PR blocks (V/bias columns are zero for reprojection);
            # embedded into the 15-d VI system after assembly
            o = lm.Observations(
                cam=jnp.stack([obs.anchor, obs.obs_kf], axis=-1),
                pt=obs.pt,
                Jc=jnp.stack([J_pr0, J_pri], axis=1),
                Jp=J_rho, r=r, w=w)
            with jax.named_scope("idp_build"):
                Hcc6, g6, Hpp, g_p, Wcp6, _ = lm.build_landmark_system(
                    o, free_cam, Nc, 6, Np, DP)
            H = jnp.zeros((Nc, DC, Nc, DC), r.dtype)
            g = jnp.zeros((Nc, DC), r.dtype)
            prv, bias = _imu_edge_factors(ns, edges, gw)
            cost = cost + jnp.sum(
                prv.w * jnp.einsum('er,ers,es->e', prv.r, prv.info, prv.r))
            cost = cost + jnp.sum(
                bias.w * jnp.einsum('er,ers,es->e', bias.r, bias.info, bias.r))
            H, g, _ = lm.accumulate_cam_factors(H, g, jnp.zeros((), r.dtype), prv, free_cam)
            H, g, _ = lm.accumulate_cam_factors(H, g, jnp.zeros((), r.dtype), bias, free_cam)
            if prior is not None:
                pf = _prior_factor(ns, prior)
                cost = cost + jnp.sum(
                    pf.w * jnp.einsum('er,ers,es->e', pf.r, pf.info, pf.r))
                H, g, _ = lm.accumulate_cam_factors(
                    H, g, jnp.zeros((), r.dtype), pf, free_cam)
            H = H.at[:, :6, :, :6].add(Hcc6)
            g = g.at[:, :6].add(g6)
            return (H, g, Hpp, g_p, Wcp6), cost

        def solve(lin, lam):
            H, g, Hpp, g_p, Wcp6 = lin
            with jax.named_scope("idp_schur"):
                dxc, dxp = lm.schur_solve_pr(H, g, Hpp, g_p, Wcp6, lam,
                                             free_cam, pt_mask)
            return dxc, dxp[:, 0]

        return linearize, solve

    def classify(x, valid0):
        ns, rho = x
        r, _, _, _, z = per_obs(ns, rho)
        chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
        return valid0 * ((chi2 <= huber_delta2) & (z > 1e-6)).astype(valid0.dtype)

    # two-round protocol on the fused driver (lm_two_phase's structure with
    # lm_optimize_fused's one-pass iterations); rtol>0 = abortable-BA mode
    # (mbAbortBA): single round WITH early exit, matching lm_two_phase's
    # `not enable or rtol > 0` routing (ADVICE r4: previously the rtol branch
    # silently dropped the early exit too)
    if two_phase and rtol == 0.0:
        it1 = max(2, int(round(iters * 0.4)))
        it2 = max(2, iters - it1)
        lin1, sol1 = make_fns(obs.valid)
        x1, _, _ = lm.lm_optimize_fused((ns0, rho0), lin1, sol1, retract,
                                        it1, lam0=lam0)
        valid2 = classify(x1, obs.valid)
        lin2, sol2 = make_fns(valid2)
        (ns, rho), cost, _ = lm.lm_optimize_fused(x1, lin2, sol2, retract,
                                                  it2, lam0=lam0)
    else:
        lin1, sol1 = make_fns(obs.valid)
        (ns, rho), cost, _ = lm.lm_optimize_fused((ns0, rho0), lin1, sol1,
                                                  retract, iters, lam0=lam0,
                                                  rtol=rtol)
    ns = ns._replace(R=lie.so3_normalize_fast(ns.R))
    r, _, _, _, z = per_obs(ns, rho)
    chi2 = jnp.sum(r * r, axis=-1) * obs.inv_sigma2
    chi2 = jnp.where(z > 0, chi2, jnp.full_like(chi2, 1e9))
    return ns, rho, chi2, cost


@partial(jax.jit, static_argnames=("iters", "rtol", "two_phase", "Pw"))
def vi_window_ba(ns_w, mp_pos, mp_active, obs_pt, obs_cam, obs_uv,
                 obs_inv_sigma2, obs_valid, edges: IMUEdges, camera: Camera,
                 ext: factors.Extrinsics, gw, free_cam,
                 prior: PriorFactor | None = None, iters: int = 8,
                 rtol: float = 0.0, two_phase: bool = True, Pw: int = 4096):
    """The pipeline's windowed VI BA entry, FUSED and LANDMARK-COMPACTED.

    The production window references only the ~2-4k landmarks its keyframes
    observe, but the map table holds 16k+ slots — solving in full-table index
    space made every (P,)-sized scatter/gather/Schur op pay for the whole
    table instead of the true landmark count). Here the window's landmarks are compacted to a fixed Pw-slot
    problem in-graph (cumsum ids over the observed mask), anchored, solved
    (vi_ba_idp), and scattered back — ONE device program for the whole event
    stage. Points past Pw (never seen in practice; the window can reference
    at most n*F uniques) drop their observations for this solve.

    Returns (ns2, mp_pos2, chi2, idp_valid) with chi2/idp_valid aligned to
    the input observation order (full-table pt indices)."""
    P = mp_pos.shape[0]
    n = ns_w.P.shape[0]
    ov = (obs_valid > 0) & mp_active[obs_pt]
    present = jnp.zeros(P + 1, bool).at[jnp.where(ov, obs_pt, P)].set(
        True, mode="drop")[:P]
    cid = jnp.cumsum(present.astype(jnp.int32)) - 1          # (P,)
    keep = present & (cid < Pw)
    # inverse map compact -> full slot (unused compact slots point at 0 with
    # used=False; their rho stays frozen via rho_free=0)
    tgt = jnp.where(keep, cid, Pw)
    slot_of = jnp.zeros(Pw, jnp.int32).at[tgt].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop")
    used = jnp.zeros(Pw, bool).at[tgt].set(True, mode="drop")
    pt_c = jnp.where(keep[obs_pt], cid[obs_pt], 0)
    valid_c = (ov & keep[obs_pt]).astype(obs_valid.dtype)
    mp_pos_c = mp_pos[slot_of]

    BIGI = jnp.int32(2 ** 30)
    anchor_loc = jnp.full((Pw,), BIGI).at[pt_c].min(
        jnp.where(valid_c > 0, obs_cam, BIGI), mode="drop")
    has_anchor = anchor_loc < n
    anchor_cl = jnp.clip(anchor_loc, 0, n - 1)
    is_anchor_obs = (valid_c > 0) & (obs_cam == anchor_cl[pt_c]) \
        & has_anchor[pt_c]
    uv0 = jnp.zeros((Pw, 2), obs_uv.dtype).at[
        jnp.where(is_anchor_obs, pt_c, Pw)].set(obs_uv, mode="drop")
    rho0 = xyz_to_idp(mp_pos_c, ns_w.P[anchor_cl], ns_w.R[anchor_cl], uv0,
                      camera, ext)
    idp_valid = ((valid_c > 0) & ~is_anchor_obs
                 & has_anchor[pt_c]).astype(jnp.float32)
    idp_obs = IDPObs(anchor=anchor_cl[pt_c], obs_kf=obs_cam, pt=pt_c,
                     uv0=uv0[pt_c], uv=obs_uv, inv_sigma2=obs_inv_sigma2,
                     valid=idp_valid)
    rho_free = (jnp.zeros((Pw,), jnp.float32).at[pt_c].max(
        idp_valid, mode="drop") * used)
    ns2, rho, chi2, cost = vi_ba_idp.__wrapped__(
        ns_w, rho0, idp_obs, edges, camera, ext, gw, free_cam, rho_free,
        iters=iters, prior=prior, rtol=rtol, two_phase=two_phase)
    Xw = idp_to_xyz(rho, uv0, ns2.P[anchor_cl], ns2.R[anchor_cl], camera, ext)
    upd = (rho_free > 0)
    mp_pos2 = mp_pos.at[jnp.where(upd, slot_of, P)].set(
        jnp.where(upd[:, None], Xw, mp_pos_c), mode="drop")
    return ns2, mp_pos2, chi2, idp_valid


@partial(jax.jit,
         static_argnames=("iters", "rtol", "two_phase", "Pw", "do_prune"))
def window_vi_ba_map(m, ks, idx_i, idx_j, ev, n_real, free_cam,
                     camera: Camera, ext: factors.Extrinsics, gw,
                     sigma_bg, sigma_ba, prior: PriorFactor | None = None,
                     iters: int = 8, rtol: float = 0.0, two_phase: bool = True,
                     Pw: int = 4096, do_prune: bool = True,
                     chi2_gate: float = CHI2_MONO):
    """The ENTIRE windowed VI-BA event stage as one device program, operating
    directly on the MapState: observation gather from the keyframe tables,
    preintegration-edge assembly (with masked-edge identity infos), the
    landmark-compacted IDP solve (vi_window_ba), NavState/landmark
    scatter-back, and the post-BA chi2 association prune. The eager form of
    this stage is ~25 host dispatches per keyframe event around the solve.

    ks: (n,) padded window+fixed slots; idx_i/idx_j/ev: (E,) edge index lists
    from the host (SlamSystem._imu_edge_lists); n_real: traced count of real
    (non-pad) slots; free_cam: (n,) free mask. Returns the updated MapState.
    """
    Fn = m.F
    n = ks.shape[0]
    cam_idx = jnp.repeat(jnp.arange(n, dtype=jnp.int32), Fn)
    mp = m.kf_mp[ks].reshape(-1)
    uv = m.kf_uv[ks].reshape(-1, 2)
    lvl = m.kf_level[ks].reshape(-1)
    fv = m.kf_feat_valid[ks].reshape(-1)
    valid = (mp >= 0) & fv & (cam_idx < n_real)
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * lvl.astype(jnp.float32)))
    pt = jnp.clip(mp, 0, m.P - 1)
    # PRV/bias edges (SlamSystem._imu_edges semantics, in-graph)
    pre = jax.tree_util.tree_map(lambda x: x[ks[idx_j]], m.kf_preint)
    info_prv = factors.imu_prv_info(pre)
    info_bias = factors.bias_rw_info(pre.dT, sigma_bg, sigma_ba)
    sel = ev[:, None, None] > 0
    info_prv = jnp.where(sel, info_prv, jnp.eye(9, dtype=info_prv.dtype))
    info_bias = jnp.where(sel, info_bias, jnp.eye(6, dtype=info_bias.dtype))
    edges = IMUEdges(i=idx_i, j=idx_j, pre=pre, info_prv=info_prv,
                     info_bias=info_bias, valid=ev)
    ns_w = jax.tree_util.tree_map(lambda a: a[ks], m.kf_ns)
    ns2, mp_pos2, chi2, idp_valid = vi_window_ba.__wrapped__(
        ns_w, m.mp_pos, m.mp_active, pt, cam_idx, uv, inv_sigma2,
        valid.astype(jnp.float32), edges, camera, ext, gw, free_cam,
        prior=prior, iters=iters, rtol=rtol, two_phase=two_phase, Pw=Pw)
    put = scatter_slots(ks, n_real, m.K)
    kf_ns2 = jax.tree_util.tree_map(
        lambda full, w: full.at[put].set(w, mode="drop"), m.kf_ns, ns2)
    m = m._replace(kf_ns=kf_ns2, mp_pos=mp_pos2)
    if do_prune:
        bad = (chi2 > chi2_gate * 1.5) & (idp_valid > 0)
        rows = jnp.where(bad.reshape(n, -1), -1, m.kf_mp[ks])
        m = m._replace(kf_mp=m.kf_mp.at[put].set(rows, mode="drop"))
    return m


def xyz_to_idp(pts_w, anchor_P, anchor_R, anchor_uv_ideal, cam: Camera,
               ext: factors.Extrinsics):
    """Convert world landmarks to anchored inverse depth w.r.t. their anchor
    keyframe camera: rho = 1/depth along the anchor ray."""
    RwbT = jnp.swapaxes(anchor_R, -1, -2)
    Pb = (RwbT @ (pts_w - anchor_P)[..., None])[..., 0]
    Pc = (ext.Rcb @ Pb[..., None])[..., 0] + ext.tcb
    return 1.0 / jnp.maximum(Pc[..., 2], 1e-6)


def idp_to_xyz(rho, uv0, anchor_P, anchor_R, cam: Camera, ext: factors.Extrinsics):
    """Anchored inverse depth back to world coordinates."""
    d = 1.0 / jnp.maximum(rho, 1e-6)
    xn = jnp.stack([(uv0[..., 0] - cam.cx) / cam.fx,
                    (uv0[..., 1] - cam.cy) / cam.fy], -1)
    Pc = jnp.concatenate([xn * d[..., None], d[..., None]], axis=-1)
    Rbc = jnp.swapaxes(ext.Rcb, -1, -2)
    Pb = (Rbc @ (Pc - ext.tcb)[..., None])[..., 0]
    return (anchor_R @ Pb[..., None])[..., 0] + anchor_P
