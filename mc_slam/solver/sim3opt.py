"""Pixel-space Sim3 refinement between two keyframes.

Replaces Optimizer::OptimizeSim3 (src/Optimizer.cpp:4579): given matched map
points expressed in each keyframe's camera frame and their observed pixels,
optimize the relative Sim3 S12 with forward (P2 -> cam1) and inverse
(P1 -> cam2) reprojection edges, Huber robust weights, chi2 gating at 9.21
(the reference's th2), left-multiplicative retraction.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.camera import Camera
from mc_slam.solver import factors, lm

CHI2_SIM3 = 9.21


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_sim3(s0, R0, t0, Pc1, Pc2, uv1, uv2, w, cam: Camera,
                  iters: int = 15, huber_delta2: float = CHI2_SIM3,
                  fix_scale: bool = False):
    """Refine S12 (mapping cam2 coords into cam1). Returns (s, R, t, n_inliers).

    Pc1/Pc2 (N,3): the matched landmark in each camera frame; uv1/uv2 (N,2):
    its observed (ideal) pixels in each image; w (N,): validity.
    """

    def residuals(x):
        s, R, t = x
        r1, J1, z1 = factors.sim3_reproj(cam, s, R, t, Pc2, uv1)
        si, Ri, ti = lie.sim3_inv(s, R, t)
        r2, J2i, z2 = factors.sim3_reproj(cam, si, Ri, ti, Pc1, uv2)
        return r1, J1, z1, r2, J2i, z2

    def chi2_of(x):
        r1, _, z1, r2, _, z2 = residuals(x)
        c1 = jnp.sum(r1 * r1, -1)
        c2 = jnp.sum(r2 * r2, -1)
        return c1, c2, z1, z2

    def cost_fn(x):
        c1, c2, z1, z2 = chi2_of(x)
        # behind-camera points pay a penalty far above the Huber saturation —
        # otherwise the scale can "escape" by pushing the whole cloud past the
        # camera and collecting the bounded saturated cost
        pen = 100.0 * huber_delta2
        t1 = jnp.where(z1 > 0, lm.trunc_huber_cost(c1, huber_delta2), pen)
        t2 = jnp.where(z2 > 0, lm.trunc_huber_cost(c2, huber_delta2), pen)
        return jnp.sum(w * (t1 + t2))

    def linearize_solve(x, lam):
        s, R, t = x
        r1, J1, z1, r2, J2i, z2 = residuals(x)
        # inverse edge chain rule: S12 <- Exp(xi) S12 implies
        # S21 <- S21 Exp(-xi) = Exp(-Ad_{S21} xi) S21, so
        # d r2/d xi = -J2i @ Ad_{S21}.
        si, Ri, ti = lie.sim3_inv(s, R, t)
        Ad21 = lie.sim3_adjoint(si, Ri, ti)
        J2 = -(J2i @ Ad21)
        w1 = w * lm.trunc_huber_weight(jnp.sum(r1 * r1, -1), huber_delta2) * (z1 > 0)
        w2 = w * lm.trunc_huber_weight(jnp.sum(r2 * r2, -1), huber_delta2) * (z2 > 0)
        H = jnp.einsum('n,nri,nrj->ij', w1, J1, J1) \
            + jnp.einsum('n,nri,nrj->ij', w2, J2, J2)
        g = jnp.einsum('n,nri,nr->i', w1, J1, r1) \
            + jnp.einsum('n,nri,nr->i', w2, J2, r2)
        H = H + jnp.diag(lam * jnp.diagonal(H) + 1e-8)
        dx = -jnp.linalg.solve(H, g)
        if fix_scale:
            dx = dx.at[6].set(0.0)
        return dx

    def retract(x, dx):
        s, R, t = x
        ds, dR, dt = lie.sim3_exp(dx)
        return lie.sim3_mul(ds, dR, dt, s, R, t)

    (s, R, t), cost, _ = lm.lm_optimize((s0, R0, t0), linearize_solve, retract,
                                        cost_fn, iters)
    c1, c2, z1, z2 = chi2_of((s, R, t))
    inlier = (w > 0) & (c1 < huber_delta2) & (c2 < huber_delta2) & (z1 > 0) & (z2 > 0)
    return s, lie.so3_normalize_fast(R), t, jnp.sum(inlier)