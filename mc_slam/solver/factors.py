"""Batched residual / analytic-Jacobian kernels for every factor type in the system.

Batched replacement for the reference's g2o custom types (src/IMU/g2otypes.{h,cpp})
and the vendored g2o edge types (Thirdparty/g2o types_six_dof_expmap / types_sba /
types_seven_dof_expmap). Each function is closed-form, batched over leading dims, and
returns (residual, jacobian blocks) for the LM engine in lm.py.

Conventions
-----------
* Body pose state: (P = t_wb in world, R = R_wb world-from-body), retraction
  P <- P + dP, R <- R @ Exp(dphi) — identical to the reference's NavState/PR vertex
  (src/IMU/NavState.cpp:31-70), so Jacobians are directly comparable.
* Pure-vision mode treats body == camera (Tbc = I).
* Reprojection residual r = project(Pc) - uv_obs (2,).
* IMU PRV residual order [rP, rPhi, rV] (9,), matching EdgeNavStatePRV
  (src/IMU/g2otypes.cpp:163-227) so information matrices map 1:1.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera, project_jacobian


class Extrinsics(NamedTuple):
    """Camera-from-body extrinsic: Pc = Rcb @ Pb + tcb."""
    Rcb: jnp.ndarray  # (3, 3)
    tcb: jnp.ndarray  # (3,)


def identity_extrinsics(dtype=jnp.float32) -> Extrinsics:
    return Extrinsics(jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype))


def extrinsics_from_Tbc(Tbc, dtype=jnp.float32) -> Extrinsics:
    """From the body-from-camera matrix Tbc (config Tbc, config/euroc.yaml:40-44)."""
    Tbc = jnp.asarray(Tbc, dtype)
    Rbc, pbc = Tbc[:3, :3], Tbc[:3, 3]
    Rcb = Rbc.T
    return Extrinsics(Rcb=Rcb, tcb=-Rcb @ pbc)


# ---------------------------------------------------------------------------
# Reprojection factor, XYZ landmark, body-pose PR block
# (EdgeNavStatePRPointXYZ, src/IMU/g2otypes.cpp:370-440)
# ---------------------------------------------------------------------------

def reproj_xyz(cam: Camera, ext: Extrinsics, P_wb, R_wb, Pw, uv):
    """Residual + Jacobians for a batch of observations.

    Inputs broadcast: P_wb (...,3), R_wb (...,3,3), Pw (...,3), uv (...,2).
    Returns r (...,2), J_pr (...,2,6) w.r.t. [dP, dphi], J_pt (...,2,3) w.r.t. Pw,
    and z (...,) camera depth for validity masking.
    """
    RwbT = jnp.swapaxes(R_wb, -1, -2)
    Pb = (RwbT @ (Pw - P_wb)[..., None])[..., 0]       # point in body frame
    Pc = (ext.Rcb @ Pb[..., None])[..., 0] + ext.tcb   # point in camera frame
    uv_hat, z = _project_ideal(cam, Pc)
    r = uv_hat - uv
    Jpi = project_jacobian(cam, Pc)                    # (...,2,3)
    # dPc/dP_wb = -Rcb RwbT ; dPc/dphi = Rcb hat(Pb) ; dPc/dPw = Rcb RwbT
    RcbRwbT = ext.Rcb @ RwbT
    J_P = -RcbRwbT
    J_phi = ext.Rcb @ lie.hat(Pb)
    J_pr = jnp.concatenate([Jpi @ J_P, Jpi @ J_phi], axis=-1)  # (...,2,6)
    J_pt = Jpi @ RcbRwbT
    return r, J_pr, J_pt, z


def reproj_xyz3(cam: Camera, ext: Extrinsics, P_wb, R_wb, Pw, uv, ur, bf):
    """3-row stereo/RGB-D reprojection factor (g2o::EdgeStereoSE3ProjectXYZ
    parity, ref src/Optimizer.cpp:3110-3180): residual rows [u, v, u_right]
    with the virtual right-image coordinate u_right = u - bf/z (bf = fx *
    baseline, the reference's mbf).

    ur (...,): observed u_right; entries < 0 mark monocular observations whose
    third residual row and Jacobian row are zeroed, so one padded table serves
    mixed mono/stereo problems. Returns r (...,3), J_pr (...,3,6),
    J_pt (...,3,3), z (...,).
    """
    RwbT = jnp.swapaxes(R_wb, -1, -2)
    Pb = (RwbT @ (Pw - P_wb)[..., None])[..., 0]
    Pc = (ext.Rcb @ Pb[..., None])[..., 0] + ext.tcb
    uv_hat, z = _project_ideal(cam, Pc)
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9 * jnp.ones_like(z), z)
    is_st = (ur >= 0).astype(uv_hat.dtype)
    r_ur = is_st * (uv_hat[..., 0] - bf / z_safe - ur)
    r = jnp.concatenate([uv_hat - uv, r_ur[..., None]], axis=-1)
    Jpi = project_jacobian(cam, Pc)                    # (...,2,3)
    # d(u_right)/dPc = du/dPc + [0, 0, bf/z^2]
    zero = jnp.zeros_like(z)
    row3 = Jpi[..., 0, :] + jnp.stack([zero, zero, bf / (z_safe * z_safe)], -1)
    Jpi3 = jnp.concatenate([Jpi, (is_st[..., None] * row3)[..., None, :]], axis=-2)
    RcbRwbT = ext.Rcb @ RwbT
    J_P = -RcbRwbT
    J_phi = ext.Rcb @ lie.hat(Pb)
    J_pr = jnp.concatenate([Jpi3 @ J_P, Jpi3 @ J_phi], axis=-1)  # (...,3,6)
    J_pt = Jpi3 @ RcbRwbT
    return r, J_pr, J_pt, z


def _project_ideal(cam: Camera, Pc):
    z = Pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9 * jnp.ones_like(z), z)
    u = cam.fx * Pc[..., 0] / z_safe + cam.cx
    v = cam.fy * Pc[..., 1] / z_safe + cam.cy
    return jnp.stack([u, v], axis=-1), z


# ---------------------------------------------------------------------------
# Reprojection factor, inverse-depth landmark anchored in a reference keyframe
# (EdgePRIDP, src/IMU/g2otypes.cpp:20-158). Landmark parameter: rho = 1/depth
# along the anchor ray (u0, v0) in the anchor camera.
# ---------------------------------------------------------------------------

def reproj_idp(cam: Camera, ext: Extrinsics, rho, uv0, P_wb0, R_wb0, P_wbi, R_wbi, uv):
    """Residual + Jacobians for anchored inverse-depth observations.

    rho (...,): inverse depth in the anchor camera.
    uv0 (...,2): the anchor-frame *ideal* (undistorted) pixel of the landmark.
    (P_wb0, R_wb0): anchor body pose; (P_wbi, R_wbi): observing body pose.
    Returns r (...,2), J_rho (...,2,1), J_pr0 (...,2,6), J_pri (...,2,6), z (...,).
    """
    rho_safe = jnp.maximum(rho, 1e-6)  # reference clamps the same way (g2otypes.h:40)
    d = 1.0 / rho_safe
    xn0 = jnp.stack([(uv0[..., 0] - cam.cx) / cam.fx, (uv0[..., 1] - cam.cy) / cam.fy], axis=-1)
    P0c = jnp.concatenate([xn0 * d[..., None], d[..., None]], axis=-1)  # point in anchor cam

    # anchor cam -> world: Pw = Rwb0 (Rbc P0c + pbc) + P0  with Rbc = RcbT, pbc = -RcbT tcb
    RbcP = (jnp.swapaxes(ext.Rcb, -1, -2) @ (P0c - ext.tcb)[..., None])[..., 0]
    Pw = (R_wb0 @ RbcP[..., None])[..., 0] + P_wb0

    # world -> observing camera
    RwbiT = jnp.swapaxes(R_wbi, -1, -2)
    Pbi = (RwbiT @ (Pw - P_wbi)[..., None])[..., 0]
    Pci = (ext.Rcb @ Pbi[..., None])[..., 0] + ext.tcb
    uv_hat, z = _project_ideal(cam, Pci)
    r = uv_hat - uv
    Jpi = project_jacobian(cam, Pci)

    # chain rule pieces
    Rcic0 = (ext.Rcb @ RwbiT) @ (R_wb0 @ jnp.swapaxes(ext.Rcb, -1, -2))  # obs-cam from anchor-cam rotation
    # dPci/drho = Rcic0 @ dP0c/drho ; dP0c/drho = -d * P0c (since P0c ~ 1/rho)
    J_rho = (Jpi @ (Rcic0 @ (-d[..., None] * P0c)[..., None]))  # (...,2,1)

    RcbRwbiT = ext.Rcb @ RwbiT
    # anchor pose: dPci/dP0 = Rcb RwbiT ; dPci/dphi0 = -Rcb RwbiT Rwb0 hat(RbcP)
    J_P0 = RcbRwbiT
    J_phi0 = -(RcbRwbiT @ R_wb0) @ lie.hat(RbcP)
    J_pr0 = jnp.concatenate([Jpi @ J_P0, Jpi @ J_phi0], axis=-1)

    # observing pose: dPci/dPi = -Rcb RwbiT ; dPci/dphii = Rcb hat(Pbi)
    J_Pi = -RcbRwbiT
    J_phii = ext.Rcb @ lie.hat(Pbi)
    J_pri = jnp.concatenate([Jpi @ J_Pi, Jpi @ J_phii], axis=-1)
    return r, J_rho, J_pr0, J_pri, z


# ---------------------------------------------------------------------------
# IMU preintegration factor (EdgeNavStatePRV, src/IMU/g2otypes.cpp:163-367)
# residual (9,) = [rP, rPhi, rV]; states: PR_i(6), PR_j(6), V_i(3), V_j(3), Bias_i(6)
# where Bias block is [dbg, dba].
# ---------------------------------------------------------------------------

def imu_prv(P_i, R_i, V_i, dbg_i, dba_i, P_j, R_j, V_j, pre, gw):
    """Returns r (...,9) and Jacobians:
    J_pri (...,9,6), J_prj (...,9,6), J_vi (...,9,3), J_vj (...,9,3), J_bi (...,9,6).

    pre: PreintState batch (measurement), gw: gravity in world (3,).
    """
    dT = pre.dT[..., None]
    dT2 = dT * dT
    RiT = jnp.swapaxes(R_i, -1, -2)

    dP_corr = pre.dP + (pre.J_P_bg @ dbg_i[..., None])[..., 0] + (pre.J_P_ba @ dba_i[..., None])[..., 0]
    dV_corr = pre.dV + (pre.J_V_bg @ dbg_i[..., None])[..., 0] + (pre.J_V_ba @ dba_i[..., None])[..., 0]

    pvec = P_j - P_i - V_i * dT - 0.5 * gw * dT2
    vvec = V_j - V_i - gw * dT
    rP = (RiT @ pvec[..., None])[..., 0] - dP_corr
    rV = (RiT @ vvec[..., None])[..., 0] - dV_corr

    corr_phi = (pre.J_R_bg @ dbg_i[..., None])[..., 0]
    dR_corr = pre.dR @ lie.so3_exp(corr_phi)
    rR = jnp.swapaxes(dR_corr, -1, -2) @ (RiT @ R_j)
    rPhi = lie.so3_log(rR)

    r = jnp.concatenate([rP, rPhi, rV], axis=-1)

    # Jacobians (mirrors g2otypes.cpp:296-359, PR order [dP, dphi])
    O = jnp.zeros_like(R_i)
    JrInv = lie.so3_jr_inv(rPhi)
    RjT = jnp.swapaxes(R_j, -1, -2)

    J_rP_Pi = -RiT
    J_rP_phii = lie.hat((RiT @ pvec[..., None])[..., 0])
    J_rPhi_phii = -JrInv @ (RjT @ R_i)
    J_rV_phii = lie.hat((RiT @ vvec[..., None])[..., 0])
    J_pri = jnp.concatenate([
        jnp.concatenate([J_rP_Pi, J_rP_phii], axis=-1),
        jnp.concatenate([O, J_rPhi_phii], axis=-1),
        jnp.concatenate([O, J_rV_phii], axis=-1),
    ], axis=-2)

    J_prj = jnp.concatenate([
        jnp.concatenate([RiT, O], axis=-1),
        jnp.concatenate([O, JrInv], axis=-1),
        jnp.concatenate([O, O], axis=-1),
    ], axis=-2)

    J_vi = jnp.concatenate([-RiT * dT[..., None], O, -RiT], axis=-2)
    J_vj = jnp.concatenate([O, O, RiT], axis=-2)

    ExpNegrPhi = lie.so3_exp(-rPhi)
    JrCorr = lie.so3_jr(corr_phi)
    J_rPhi_dbg = -(JrInv @ ExpNegrPhi) @ (JrCorr @ pre.J_R_bg)
    J_bi = jnp.concatenate([
        jnp.concatenate([-pre.J_P_bg, -pre.J_P_ba], axis=-1),
        jnp.concatenate([J_rPhi_dbg, jnp.zeros_like(O)], axis=-1),
        jnp.concatenate([-pre.J_V_bg, -pre.J_V_ba], axis=-1),
    ], axis=-2)

    return r, J_pri, J_prj, J_vi, J_vj, J_bi


def imu_prv_info(pre, dtype=None):
    """9x9 information matrix of the PRV factor: inverse of the preintegration
    covariance re-ordered P,V,Phi -> P,Phi,V (Optimizer.cpp sets Info from
    cov_P_V_Phi with that permutation).

    Inverted after diagonal (Jacobi) normalization: short-window covariances
    have entries spanning ~1e-12..1e-8, and a raw f32 inverse occasionally
    comes out indefinite — an indefinite information matrix lets the
    optimizer run the bias away while "decreasing" the quadratic cost (seen
    as a 57 rad/s per-frame gyro-bias step on a long run). The reference
    escapes this only by doing everything in double."""
    cov = pre.cov
    perm = jnp.asarray([0, 1, 2, 6, 7, 8, 3, 4, 5])
    cov_prv = cov[..., perm, :][..., :, perm]
    d = jnp.sqrt(jnp.clip(jnp.diagonal(cov_prv, axis1=-2, axis2=-1),
                          1e-16, None))
    dinv = 1.0 / d
    cov_n = cov_prv * dinv[..., :, None] * dinv[..., None, :]
    eye = jnp.eye(9, dtype=cov.dtype)
    info_n = jnp.linalg.inv(cov_n + 1e-6 * eye)
    return info_n * dinv[..., :, None] * dinv[..., None, :]


# ---------------------------------------------------------------------------
# Bias random-walk factor (EdgeNavStateBias, src/IMU/g2otypes.cpp:589-615):
# r = [(dbg_j + bg_j) - (dbg_i + bg_i), (dba_j + ba_j) - (dba_i + ba_i)]
# With the convention that base bias bg/ba is shared between relinearizations,
# the residual reduces to delta-bias differences.
# ---------------------------------------------------------------------------

def bias_rw(bg_i_full, ba_i_full, bg_j_full, ba_j_full):
    """r (...,6); J_bi = -I6, J_bj = +I6 (returned implicitly by the caller)."""
    return jnp.concatenate([bg_j_full - bg_i_full, ba_j_full - ba_i_full], axis=-1)


def bias_rw_info(dT, sigma_bg, sigma_ba, dtype=jnp.float32):
    """info = diag(1/(sigma^2 * dT)) per block (Optimizer.cpp:1771-1788)."""
    dT = jnp.asarray(dT, dtype)
    ig = 1.0 / (sigma_bg**2 * dT)
    ia = 1.0 / (sigma_ba**2 * dT)
    ones3 = jnp.ones(dT.shape + (3,), dtype)
    diag = jnp.concatenate([ig[..., None] * ones3, ia[..., None] * ones3], axis=-1)
    return jnp.zeros(dT.shape + (6, 6), dtype) + diag[..., None] * jnp.eye(6, dtype=dtype)


# ---------------------------------------------------------------------------
# 15d prior factor on [PR, V, Bias] (EdgeNavStatePriorPVRBias re-ordered;
# src/IMU/g2otypes.cpp:801-830). Residual uses the same retraction as the state:
# rP = P - P0, rPhi = Log(R0^T R), rV = V - V0, rdbg = dbg - dbg0, rdba = dba - dba0.
# ---------------------------------------------------------------------------

def prior_pr_v_bias(P, R, V, dbg, dba, P0, R0, V0, dbg0, dba0):
    """r (...,15) in order [rP(3), rPhi(3), rV(3), rdbg(3), rdba(3)].
    J w.r.t. [dP,dphi,dV,ddbg,ddba] is block-diag(I, JrInv(rPhi), I, I, I)."""
    rPhi = lie.so3_log(jnp.swapaxes(R0, -1, -2) @ R)
    r = jnp.concatenate([P - P0, rPhi, V - V0, dbg - dbg0, dba - dba0], axis=-1)
    JrInv = lie.so3_jr_inv(rPhi)
    eye = jnp.broadcast_to(jnp.eye(15, dtype=r.dtype), r.shape[:-1] + (15, 15))
    J = eye.at[..., 3:6, 3:6].set(JrInv)
    return r, J


# ---------------------------------------------------------------------------
# Gyro-bias-only factor for VI init (EdgeGyrBias, src/IMU/g2otypes.cpp:1115-1161):
# r = Log((dRij Exp(J_R_bg bg))^T Rbi^T Rbj)
# ---------------------------------------------------------------------------

def gyr_bias(bg, dRij, J_R_bg, R_bi, R_bj):
    """Residual (...,3) and Jacobian (...,3,3) w.r.t. bg."""
    corr = lie.so3_exp((J_R_bg @ bg[..., None])[..., 0])
    rel = jnp.swapaxes(R_bi, -1, -2) @ R_bj
    rR = jnp.swapaxes(dRij @ corr, -1, -2) @ rel
    r = lie.so3_log(rR)
    # dr/dbg = -JrInv(r) Exp(-r) Jr(J bg) J   (same structure as the PRV phi-bias block)
    JrInv = lie.so3_jr_inv(r)
    J = -(JrInv @ lie.so3_exp(-r)) @ (lie.so3_jr((J_R_bg @ bg[..., None])[..., 0]) @ J_R_bg)
    return r, J


# ---------------------------------------------------------------------------
# Sim3 reprojection factors for OptimizeSim3 (g2o types_seven_dof_expmap):
# forward: project anchor-frame-2 point into frame 1 via S12; inverse: project
# frame-1 point into frame 2 via S12^{-1}. State: Sim3 [rho, phi, sigma],
# retraction S <- Exp(xi) * S (left-multiplicative, g2o convention).
# ---------------------------------------------------------------------------

def sim3_reproj(cam: Camera, s, R, t, Pc_other, uv):
    """r (...,2), J (...,2,7) w.r.t. left-mult sim3 update on (s,R,t).

    Pc_other: 3D point in the *other* camera frame; transformed point
    Pc = s R Pc_other + t is projected in this camera.
    """
    Pc = s[..., None] * (R @ Pc_other[..., None])[..., 0] + t
    uv_hat, z = _project_ideal(cam, Pc)
    r = uv_hat - uv
    Jpi = project_jacobian(cam, Pc)
    # left-mult: S' = Exp([drho,dphi,dsig]) S => dPc = drho + dphi x Pc + dsig*Pc
    # (to first order; translation part of Exp acts as W@drho ~ drho)
    J_rho = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), Pc.shape[:-1] + (3, 3))
    J_phi = -lie.hat(Pc)
    J_sig = Pc[..., None]
    J = Jpi @ jnp.concatenate([J_rho, J_phi, J_sig], axis=-1)
    return r, J, z


# ---------------------------------------------------------------------------
# Sim3/SE3 pose-graph edge (OptimizeEssentialGraph, src/Optimizer.cpp:4243-4578):
# residual = Log(Sji_meas * Si * Sj^{-1})? g2o EdgeSim3 uses
# error = log(Sji * Si * Sj^-1) with vertices storing world-from... We define:
# vertices S_iw (world->i), measurement S_ji = S_jw * S_iw^{-1};
# r = Log(S_ji_meas * S_iw * S_jw^{-1}) (7,). Jacobians computed numerically-free
# via adjoint-less first-order approximation is poor; we use exact-ish analytic
# form below with left-mult retraction on both vertices.
# ---------------------------------------------------------------------------

def sim3_graph_residual(s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """r = log(S_m * S_i * S_j^{-1}) (...,7)."""
    si, Ri, ti = lie.sim3_mul(s_m, R_m, t_m, s_i, R_i, t_i)
    sji_inv = lie.sim3_inv(s_j, R_j, t_j)
    se, Re, te = lie.sim3_mul(si, Ri, ti, *sji_inv)
    return lie.sim3_log(se, Re, te)
