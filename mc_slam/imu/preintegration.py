"""On-manifold IMU preintegration (Forster TRO'17) as a fused ``lax.scan``.

Device-side equivalent of the reference's IMUPreintegrator
(src/IMU/IMUPreintegrator.cpp:63-112): per-sample incremental update of
(dP, dV, dR), the 9x9 covariance in P/V/Phi block order, and the five bias
Jacobians (J_P_bg, J_P_ba, J_V_bg, J_V_ba, J_R_bg).

A whole batch of preintegration windows (e.g. all keyframe pairs of a local
window, or all frames of a sequence) runs as one vmapped scan over a padded
(T, 7) sample buffer [omega(3), acc(3), dt(1)] with dt == 0 padding — a zero-dt
sample is an exact no-op of the recursion, so padding needs no masks.

Noise model matches src/IMU/imudata.{h,cpp}: continuous-time noise densities
are turned into the discrete covariances sigma^2/dt inside the scan.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie


class IMUNoise(NamedTuple):
    """Continuous-time IMU noise densities (EuRoC defaults of the reference,
    src/IMU/imudata.cpp:25-37)."""
    sigma_g: jnp.ndarray   # gyro white noise [rad/s/sqrt(Hz)]
    sigma_a: jnp.ndarray   # accel white noise [m/s^2/sqrt(Hz)]
    sigma_bg: jnp.ndarray  # gyro bias random walk [rad/s^2/sqrt(Hz)]
    sigma_ba: jnp.ndarray  # accel bias random walk [m/s^3/sqrt(Hz)]


def euroc_noise(dtype=jnp.float32) -> IMUNoise:
    # Reference hardcodes discrete covs: gyr (1.7e-4)^2/0.005, acc (2e-3)^2/0.005*100,
    # i.e. continuous sigma_g = 1.7e-4, sigma_a = 2e-3*10 = 2e-2; bias RW covs are
    # used directly per-second: (2e-5)^2 and (5e-3)^2.
    return IMUNoise(
        sigma_g=jnp.asarray(1.7e-4, dtype),
        sigma_a=jnp.asarray(2e-2, dtype),
        sigma_bg=jnp.asarray(2e-5, dtype),
        sigma_ba=jnp.asarray(5e-3, dtype),
    )


class PreintState(NamedTuple):
    dP: jnp.ndarray        # (..., 3)
    dV: jnp.ndarray        # (..., 3)
    dR: jnp.ndarray        # (..., 3, 3)
    J_P_bg: jnp.ndarray    # (..., 3, 3)
    J_P_ba: jnp.ndarray    # (..., 3, 3)
    J_V_bg: jnp.ndarray    # (..., 3, 3)
    J_V_ba: jnp.ndarray    # (..., 3, 3)
    J_R_bg: jnp.ndarray    # (..., 3, 3)
    cov: jnp.ndarray       # (..., 9, 9) covariance of [dP, dV, dPhi]
    dT: jnp.ndarray        # (...,) total integration time


def preint_identity(batch_shape=(), dtype=jnp.float32) -> PreintState:
    z3 = jnp.zeros(batch_shape + (3,), dtype)
    z33 = jnp.zeros(batch_shape + (3, 3), dtype)
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
    return PreintState(
        dP=z3, dV=z3, dR=I,
        J_P_bg=z33, J_P_ba=z33, J_V_bg=z33, J_V_ba=z33, J_R_bg=z33,
        cov=jnp.zeros(batch_shape + (9, 9), dtype), dT=jnp.zeros(batch_shape, dtype),
    )


def preint_update(st: PreintState, omega, acc, dt, noise: IMUNoise) -> PreintState:
    """One bias-corrected sample update. omega/acc are already bias-subtracted.

    Mirrors IMUPreintegrator::update (src/IMU/IMUPreintegrator.cpp:63-112):
    covariance propagated first with the *old* dP/dV/dR, then Jacobians, then state.
    A dt == 0 sample leaves the state exactly unchanged (used for padding).
    """
    dtype = st.dP.dtype
    dt = jnp.asarray(dt, dtype)
    dt2 = dt * dt
    w_dt = omega * dt[..., None]
    dR_inc = lie.so3_exp(w_dt)
    Jr = lie.so3_jr(w_dt)
    acc_hat = lie.hat(acc)

    # --- covariance propagation (PVPhi order) ---
    # A = [[I, I*dt, -0.5*dR*hat(a)*dt^2],
    #      [0, I,    -dR*hat(a)*dt      ],
    #      [0, 0,     dR_inc^T          ]]
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=dtype), st.dR.shape)
    Z3 = jnp.zeros_like(I3)
    dRa = st.dR @ acc_hat
    A = jnp.concatenate([
        jnp.concatenate([I3, I3 * dt[..., None, None], -0.5 * dt2[..., None, None] * dRa], axis=-1),
        jnp.concatenate([Z3, I3, -dt[..., None, None] * dRa], axis=-1),
        jnp.concatenate([Z3, Z3, jnp.swapaxes(dR_inc, -1, -2)], axis=-1),
    ], axis=-2)

    # discrete measurement covariances (sigma^2 / dt); guard dt == 0 padding
    dt_safe = jnp.where(dt > 0, dt, jnp.ones_like(dt))
    cov_g = (noise.sigma_g ** 2) / dt_safe
    cov_a = (noise.sigma_a ** 2) / dt_safe

    # Bg = [0; 0; Jr*dt],  Ca = [0.5*dR*dt^2; dR*dt; 0]
    Bg_blk = Jr * dt[..., None, None]
    Ca_top = 0.5 * dt2[..., None, None] * st.dR
    Ca_mid = dt[..., None, None] * st.dR

    cov_new = A @ st.cov @ jnp.swapaxes(A, -1, -2)
    # += Bg * cov_g * Bg^T  (only Phi block), += Ca * cov_a * Ca^T (P/V blocks)
    BgBgT = cov_g[..., None, None] * (Bg_blk @ jnp.swapaxes(Bg_blk, -1, -2))
    PP = cov_a[..., None, None] * (Ca_top @ jnp.swapaxes(Ca_top, -1, -2))
    PV = cov_a[..., None, None] * (Ca_top @ jnp.swapaxes(Ca_mid, -1, -2))
    VV = cov_a[..., None, None] * (Ca_mid @ jnp.swapaxes(Ca_mid, -1, -2))
    add = jnp.concatenate([
        jnp.concatenate([PP, PV, Z3], axis=-1),
        jnp.concatenate([jnp.swapaxes(PV, -1, -2), VV, Z3], axis=-1),
        jnp.concatenate([Z3, Z3, BgBgT], axis=-1),
    ], axis=-2)
    cov_new = cov_new + add

    # --- bias Jacobians (order matters: P uses old V/R Jacobians) ---
    J_P_ba = st.J_P_ba + st.J_V_ba * dt[..., None, None] - 0.5 * dt2[..., None, None] * st.dR
    J_P_bg = st.J_P_bg + st.J_V_bg * dt[..., None, None] - 0.5 * dt2[..., None, None] * (dRa @ st.J_R_bg)
    J_V_ba = st.J_V_ba - dt[..., None, None] * st.dR
    J_V_bg = st.J_V_bg - dt[..., None, None] * (dRa @ st.J_R_bg)
    J_R_bg = jnp.swapaxes(dR_inc, -1, -2) @ st.J_R_bg - Bg_blk

    # --- measurement delta state ---
    Ra = (st.dR @ acc[..., None])[..., 0]
    dP = st.dP + st.dV * dt[..., None] + 0.5 * dt2[..., None] * Ra
    dV = st.dV + Ra * dt[..., None]
    dR = lie.so3_normalize_fast(st.dR @ dR_inc)

    return PreintState(
        dP=dP, dV=dV, dR=dR,
        J_P_bg=J_P_bg, J_P_ba=J_P_ba, J_V_bg=J_V_bg, J_V_ba=J_V_ba, J_R_bg=J_R_bg,
        cov=cov_new, dT=st.dT + dt,
    )


@jax.jit
def preintegrate(samples, bg, ba, noise: IMUNoise, init: PreintState | None = None) -> PreintState:
    """Preintegrate a window of IMU samples with a fused scan.

    samples: (T, 7) array of [omega(3), acc(3), dt(1)]; dt == 0 rows are padding.
    bg, ba: (3,) biases subtracted from every sample.
    Batched via ``jax.vmap`` for (B, T, 7) windows.

    Jitted at the top level so biases/noise/init are traced ARGUMENTS: an
    eager ``lax.scan`` bakes them in as compile-time constants and compiles a
    fresh executable per call — per-frame tracking was recompiling the scan
    every frame (and exhausting vm.max_map_count on long runs).
    """
    if init is None:
        init = preint_identity(dtype=samples.dtype)

    def step(st, row):
        omega = row[0:3] - bg
        acc = row[3:6] - ba
        dt = row[6]
        return preint_update(st, omega, acc, dt, noise), None

    out, _ = jax.lax.scan(step, init, samples)
    return out


@jax.jit
def predict_navstate(ns, preint: PreintState, gw):
    """Propagate a NavState through a preintegrated delta (Converter::updateNS,
    src/Converter.cpp:10-36): with first-order bias correction using the stored
    Jacobians and the state's delta-bias.

        R_j = R_i @ dR @ Exp(J_R_bg dbg)
        V_j = V_i + g dT + R_i (dV + J_V_bg dbg + J_V_ba dba)
        P_j = P_i + V_i dT + 0.5 g dT^2 + R_i (dP + J_P_bg dbg + J_P_ba dba)
    """
    dt = preint.dT[..., None]
    dbg, dba = ns.dbg, ns.dba
    dP = preint.dP + (preint.J_P_bg @ dbg[..., None])[..., 0] + (preint.J_P_ba @ dba[..., None])[..., 0]
    dV = preint.dV + (preint.J_V_bg @ dbg[..., None])[..., 0] + (preint.J_V_ba @ dba[..., None])[..., 0]
    dR = preint.dR @ lie.so3_exp((preint.J_R_bg @ dbg[..., None])[..., 0])
    P = ns.P + ns.V * dt + 0.5 * gw * dt * dt + (ns.R @ dP[..., None])[..., 0]
    V = ns.V + gw * dt + (ns.R @ dV[..., None])[..., 0]
    R = ns.R @ dR
    return ns._replace(P=P, V=V, R=R)
