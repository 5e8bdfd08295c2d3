"""Visual-inertial initialization: gyro bias, scale, gravity, accel bias, velocities.

Device-side equivalent of LocalMapping::TryInitVIO (src/LocalMapping.cpp:200-893),
implementing the VI-ORB scheme (Mur-Artal & Tardos arXiv:1610.05949):
  step 1: gyro bias by Gauss-Newton on relative-rotation residuals
          (Optimizer::OptimizeInitialGyroBias, src/Optimizer.cpp:2910-2971)
  step 2: scale + gravity from the linear system A[3(N-2) x 4][s; gw] = B
          (eq. 12/13; src/LocalMapping.cpp:307-374)
  step 3: accel bias + gravity-direction refinement C[3(N-2) x 6][s; dtheta_xy; ba] = D
          (eq. 19/20; src/LocalMapping.cpp:384-483)
  step 4: per-keyframe velocities (eq. 18 / IMU motion model;
          src/LocalMapping.cpp:601-647)

All solvers are batched dense linear algebra over fixed-size keyframe windows with
validity masks (padded keyframes get zero rows).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.imu.preintegration import PreintState
from mc_slam.solver import factors


class VIInitResult(NamedTuple):
    bg: jnp.ndarray        # (3,) gyro bias
    ba: jnp.ndarray        # (3,) accel bias
    scale: jnp.ndarray     # () metric scale of the visual map
    scale_star: jnp.ndarray  # () scale from step 2 (diagnostic, fscale logging)
    gw: jnp.ndarray        # (3,) gravity in world (refined)
    Rwi: jnp.ndarray       # (3,3) world-from-inertial rotation
    cond: jnp.ndarray      # (6,) singular values of C (condition diagnostics)


def _masked_lls(A, b, with_sv=False, rel_eps=1e-7):
    """Least squares via the normal equations (A^T A) x = A^T b.

    Replaces jnp.linalg.lstsq (SVD-backed) in the init solves: the SVD of a
    bucket-PADDED system [A; 0] is not bit-identical to the unpadded one
    under XLA (observed: a padded window flipped the gravity-refinement
    rotation on the multi-device CPU backend), while the normal equations
    are exactly padding-invariant — zero rows contribute exactly zero to
    A^T A and A^T b. The systems are tiny (<= 6 columns) and gated on
    conditioning by the caller, so the squared condition number is
    acceptable; a trace-relative Tikhonov floor bounds the worst case.
    with_sv: also return the singular values of A (from eigvalsh(A^T A),
    descending — the caller's condition diagnostics, lstsq-compatible)."""
    AtA = A.T @ A
    Atb = A.T @ b
    n = AtA.shape[0]
    eps = rel_eps * jnp.trace(AtA) / n
    x = jnp.linalg.solve(AtA + eps * jnp.eye(n, dtype=A.dtype), Atb)
    if not with_sv:
        return x
    ev = jnp.linalg.eigvalsh(AtA)
    sv = jnp.sqrt(jnp.maximum(ev[::-1], 0.0))
    return x, sv


def estimate_gyro_bias(Rwb, pre: PreintState, valid_pair, iters: int = 5):
    """Gyro bias from relative rotations of consecutive keyframes.

    Rwb: (N,3,3) body rotations (from vision, R_wc @ Rcb); pre: (N,...) batch where
    pre[k] integrates KF k-1 -> KF k (entry 0 unused); valid_pair: (N,) mask with
    [0] == 0. Gauss-Newton on sum_k || r_k(bg) ||^2.
    """
    R_i = jnp.roll(Rwb, 1, axis=0)

    def gn_step(bg, _):
        r, J = factors.gyr_bias(
            jnp.broadcast_to(bg, (Rwb.shape[0], 3)), pre.dR, pre.J_R_bg, R_i, Rwb)
        w = valid_pair[:, None]
        H = jnp.einsum('nri,nrj->ij', J * w[..., None], J)
        g = jnp.einsum('nri,nr->i', J * w[..., None], r)
        dbg = -jnp.linalg.solve(H + 1e-9 * jnp.eye(3, dtype=H.dtype), g)
        return bg + dbg, None

    bg, _ = jax.lax.scan(gn_step, jnp.zeros(3, Rwb.dtype), None, length=iters)
    return bg


def _triplet_terms(Pwc, Rwc, pre, valid_pair):
    """Common per-triplet quantities for steps 2/3. Triplet k = (k, k+1, k+2).

    Returns dict of arrays over k = 0..N-3 plus a (N-2,) triplet mask.
    """
    N = Pwc.shape[0]
    p1, p2, p3 = Pwc[:-2], Pwc[1:-1], Pwc[2:]
    R1, R2, R3 = Rwc[:-2], Rwc[1:-1], Rwc[2:]
    # pre[k] integrates (k-1 -> k): pair 1->2 is pre[1:-1+...]
    take12 = lambda x: x[1:-1]
    take23 = lambda x: x[2:]
    dt12 = take12(pre.dT)
    dt23 = take23(pre.dT)
    mask = take12(valid_pair) * take23(valid_pair)
    return dict(
        p1=p1, p2=p2, p3=p3, R1=R1, R2=R2, R3=R3,
        dt12=dt12, dt23=dt23,
        dp12=take12(pre.dP), dv12=take12(pre.dV), dp23=take23(pre.dP),
        Jpba12=take12(pre.J_P_ba), Jvba12=take12(pre.J_V_ba), Jpba23=take23(pre.J_P_ba),
        mask=mask,
    )


def estimate_scale_gravity(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb):
    """Step 2: solve [s, gw] from the 3(N-2) x 4 system (eq. 12/13).

    Pwc/Rwc: (N,3)/(N,3,3) camera poses in the (unscaled) visual world.
    """
    t = _triplet_terms(Pwc, Rwc, pre, valid_pair)
    dt12, dt23 = t['dt12'][:, None], t['dt23'][:, None]
    lam = (t['p2'] - t['p1']) * dt23 + (t['p2'] - t['p3']) * dt12          # (K,3)
    beta = 0.5 * (dt12 * dt12 * dt23 + dt12 * dt23 * dt23)                 # (K,1)
    # world-from-body = R_wc @ R_cb (reference: Rc1*Rcb, src/LocalMapping.cpp:345)
    Rwb1 = t['R1'] @ Rcb
    Rwb2 = t['R2'] @ Rcb
    gam = ((t['R3'] - t['R2']) @ pcb)[..., ] * dt12 + ((t['R1'] - t['R2']) @ pcb) * dt23 \
        + (Rwb1 @ t['dp12'][..., None])[..., 0] * dt23 \
        - (Rwb2 @ t['dp23'][..., None])[..., 0] * dt12 \
        - (Rwb1 @ t['dv12'][..., None])[..., 0] * dt12 * dt23
    m = t['mask'][:, None]
    K = lam.shape[0]
    A = jnp.concatenate([
        (lam * m).reshape(3 * K, 1),
        (jnp.broadcast_to(beta[:, :, None] * jnp.eye(3), (K, 3, 3)) * m[:, :, None]).reshape(3 * K, 3),
    ], axis=1)
    B = (gam * m).reshape(3 * K)
    x = _masked_lls(A, B)
    return x[0], x[1:4]


def refine_gravity_accbias(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb,
                           gw_star, g_mag=9.810):
    """Step 3: [s, dtheta_xy, ba] from the 3(N-2) x 6 system (eq. 19/20)."""
    t = _triplet_terms(Pwc, Rwc, pre, valid_pair)
    dtype = Pwc.dtype
    gI = jnp.asarray([0.0, 0.0, 1.0], dtype)
    gwn = gw_star / jnp.maximum(jnp.linalg.norm(gw_star), 1e-12)
    gIxgwn = jnp.cross(gI, gwn)
    n_cross = jnp.linalg.norm(gIxgwn)
    vhat = gIxgwn / jnp.maximum(n_cross, 1e-12)
    theta = jnp.arctan2(n_cross, jnp.dot(gI, gwn))
    Rwi = lie.so3_exp(vhat * theta)
    GI = gI * g_mag

    dt12, dt23 = t['dt12'][:, None], t['dt23'][:, None]
    lam = (t['p2'] - t['p1']) * dt23 + (t['p2'] - t['p3']) * dt12
    coef = (dt12 * dt12 * dt23 + dt12 * dt23 * dt23)
    phi_full = -0.5 * coef[:, :, None] * (Rwi @ lie.hat(GI))       # (K,3,3)
    phi = phi_full[..., :2]                                        # columns x,y only
    Rwb1 = t['R1'] @ Rcb
    Rwb2 = t['R2'] @ Rcb
    zeta = (Rwb2 @ t['Jpba23']) * dt12[:, :, None] \
        + (Rwb1 @ t['Jvba12']) * (dt12 * dt23)[:, :, None] \
        - (Rwb1 @ t['Jpba12']) * dt23[:, :, None]
    psi = ((t['R1'] - t['R2']) @ pcb) * dt23 \
        + (Rwb1 @ t['dp12'][..., None])[..., 0] * dt23 \
        - ((t['R2'] - t['R3']) @ pcb) * dt12 \
        - (Rwb2 @ t['dp23'][..., None])[..., 0] * dt12 \
        - (Rwb1 @ t['dv12'][..., None])[..., 0] * dt23 * dt12 \
        - 0.5 * coef * (Rwi @ GI)

    m = t['mask'][:, None]
    K = lam.shape[0]
    C = jnp.concatenate([
        (lam * m).reshape(3 * K, 1),
        (phi * m[:, :, None]).reshape(3 * K, 2),
        (zeta * m[:, :, None]).reshape(3 * K, 3),
    ], axis=1)
    D = (psi * m).reshape(3 * K)
    y, sv = _masked_lls(C, D, with_sv=True)
    s = y[0]
    dtheta = jnp.concatenate([y[1:3], jnp.zeros(1, dtype)])
    ba = y[3:6]
    Rwi_ = Rwi @ lie.so3_exp(dtheta)
    gw = Rwi_ @ GI
    return s, ba, gw, Rwi_, sv


@jax.jit
def compute_velocities(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb,
                       scale, gw, ba):
    """Step 4: per-keyframe body velocities (src/LocalMapping.cpp:601-647).

    For rows whose successor pair is valid:
      V_k = [s(wPc_{k+1} - wPc_k) + (Rwc_{k+1} - Rwc_k) pcb
             + Rwb_k (dp + Jpba ba) + 0.5 gw dt^2] / dt  — note the reference
    writes this with a leading -1/dt and flipped (wPc - wPcnext); same.
    Rows without a valid successor (the last real keyframe, and any trailing
    padding) fall back to the IMU motion model from the previous row:
      V_k = V_{k-1} + gw dt_k + Rwb_{k-1} (dv_k + Jvba ba).
    Mask-aware so callers may pad the keyframe window to a fixed bucket size
    (valid_pair[k] == 0 for pads) without recompiling per window length.
    """
    N = Pwc.shape[0]
    Rwb = Rwc @ Rcb
    dp_next = pre.dP[1:] + (pre.J_P_ba[1:] @ ba)          # (N-1,3) preint k->k+1
    dt_next = pre.dT[1:][:, None]
    # vel_k = ( s*(p_{k+1}-p_k) + (R_{k+1}-R_k) pcb
    #           - Rwb_k (dp + Jpba ba) - 0.5 gw dt^2 ) / dt
    num = (scale * (Pwc[1:] - Pwc[:-1])
           + ((Rwc[1:] - Rwc[:-1]) @ pcb)
           - (Rwb[:-1] @ dp_next[..., None])[..., 0]
           - 0.5 * gw * dt_next * dt_next)
    dt_safe = jnp.where(dt_next > 1e-9, dt_next, jnp.ones_like(dt_next))
    V_fwd = jnp.concatenate([num / dt_safe, (num / dt_safe)[-1:]], axis=0)  # (N,3)
    # motion-model fallback: V_k = V_fwd[k-1] + gw dT_k + Rwb_{k-1} dv_k
    dv = pre.dV + (pre.J_V_ba @ ba)                       # (N,3) row k: k-1 -> k
    V_mot = jnp.concatenate(
        [V_fwd[:1],
         V_fwd[:-1] + gw * pre.dT[1:, None]
         + (Rwb[:-1] @ dv[1:, :, None])[..., 0]], axis=0)
    valid_next = jnp.concatenate([valid_pair[1:], jnp.zeros(1, valid_pair.dtype)])
    return jnp.where(valid_next[:, None] > 0, V_fwd, V_mot)


@jax.jit
def apply_init_to_navstates(Pwc, Rwc, Rcb, pcb, scale, bg, ba, V):
    """Set keyframe NavStates from the visual poses and init results
    (src/LocalMapping.cpp:585-599): P = s*wPc + Rwc pcb, R = Rwc Rcb."""
    P = scale * Pwc + (Rwc @ pcb)
    R = Rwc @ Rcb
    return P, R, V


@partial(jax.jit, static_argnames=("gyro_iters",))
def try_init_vio(Pwc, Rwc, pre: PreintState, valid_pair, Rcb, pcb,
                 g_mag=9.810, gyro_iters: int = 5) -> VIInitResult:
    """Full VI-init solve (no success gating — the caller applies the 15 s rule,
    src/LocalMapping.cpp:536-539). Jitted as ONE program: the eager form
    compiles and dispatches op by op at the moment of the (single)
    successful attempt."""
    Rwb = Rwc @ Rcb
    bg = estimate_gyro_bias(Rwb, pre, valid_pair, iters=gyro_iters)
    # caller must re-preintegrate with bg before steps 2/3; we accept `pre`
    # already corrected OR apply first-order correction here:
    pre_corr = pre._replace(
        dP=pre.dP + (pre.J_P_bg @ bg), dV=pre.dV + (pre.J_V_bg @ bg),
        dR=pre.dR @ lie.so3_exp(pre.J_R_bg @ bg))
    s_star, gw_star = estimate_scale_gravity(Pwc, Rwc, pre_corr, valid_pair, Rcb, pcb)
    s, ba, gw, Rwi, sv = refine_gravity_accbias(
        Pwc, Rwc, pre_corr, valid_pair, Rcb, pcb, gw_star, g_mag)
    return VIInitResult(bg=bg, ba=ba, scale=s, scale_star=s_star, gw=gw, Rwi=Rwi,
                        cond=sv)
