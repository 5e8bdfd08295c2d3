"""Sim3/SE3 pose-graph optimization for loop closing.

Replaces Optimizer::OptimizeEssentialGraph (src/Optimizer.cpp:4243-4578):
Sim3 vertices (7 DoF; scale frozen for stereo/RGBD = SE3 mode), edges from the
loop constraint, spanning tree, covisibility and previous loop edges, LM with
tiny initial damping (reference sets lambda_init = 1e-16).

Vertices store world-from-keyframe Sim3 as (s, R, t) with LEFT-multiplicative
retraction S <- Exp(xi) S. Edge residual r = log(S_meas * S_i * S_j^{-1}) where
S_i = S_{i,w} (world->i map, g2o convention). Jacobians via vmapped jacfwd on
the 14-dim joint perturbation — closed-form adjoints are a later optimization.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam import lie
from mc_slam.solver import lm


class Sim3Graph(NamedTuple):
    # vertices: world->kf transforms (g2o VertexSim3 convention, Scw)
    s: jnp.ndarray       # (K,)
    R: jnp.ndarray       # (K,3,3)
    t: jnp.ndarray       # (K,3)
    # edges i->j with measurement S_ji = S_j * S_i^{-1}
    ei: jnp.ndarray      # (E,) int32
    ej: jnp.ndarray      # (E,) int32
    s_m: jnp.ndarray     # (E,)
    R_m: jnp.ndarray     # (E,3,3)
    t_m: jnp.ndarray     # (E,3)
    w: jnp.ndarray       # (E,) edge weight/validity
    free: jnp.ndarray    # (K,) 0/1 (loop KF fixed)


def edge_measurement(s_i, R_i, t_i, s_j, R_j, t_j):
    """S_ji = S_j * S_i^{-1} from current vertex estimates (how the reference
    builds spanning/covisibility edge measurements)."""
    si, Ri, ti = lie.sim3_inv(s_i, R_i, t_i)
    return lie.sim3_mul(s_j, R_j, t_j, si, Ri, ti)


def _edge_residual(xi_i, xi_j, s_i, R_i, t_i, s_j, R_j, t_j, s_m, R_m, t_m):
    """Residual after left-multiplicative perturbations xi on both vertices:
    r = log(S_m * (Exp(xi_i) S_i) * (Exp(xi_j) S_j)^{-1})."""
    sa, Ra, ta = lie.sim3_exp(xi_i)
    sb, Rb, tb = lie.sim3_exp(xi_j)
    s1, R1, t1 = lie.sim3_mul(sa, Ra, ta, s_i, R_i, t_i)
    s2, R2, t2 = lie.sim3_mul(sb, Rb, tb, s_j, R_j, t_j)
    sji, Rji, tji = lie.sim3_inv(s2, R2, t2)
    sm1, Rm1, tm1 = lie.sim3_mul(s_m, R_m, t_m, s1, R1, t1)
    se, Re, te = lie.sim3_mul(sm1, Rm1, tm1, sji, Rji, tji)
    return lie.sim3_log(se, Re, te)


_res_and_jac = jax.vmap(
    lambda si, Ri, ti, sj, Rj, tj, sm, Rm, tm: (
        _edge_residual(jnp.zeros(7), jnp.zeros(7), si, Ri, ti, sj, Rj, tj, sm, Rm, tm),
        jax.jacfwd(_edge_residual, argnums=(0, 1))(
            jnp.zeros(7), jnp.zeros(7), si, Ri, ti, sj, Rj, tj, sm, Rm, tm),
    ))


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def optimize_pose_graph(g: Sim3Graph, iters: int = 20, lam0: float = 1e-8,
                        fix_scale: bool = False):
    """LM over the Sim3 pose graph. Returns updated (s, R, t) per vertex."""
    K = g.s.shape[0]
    DC = 7

    def cost_fn(x):
        s, R, t = x
        r = jax.vmap(lambda i, j, sm, Rm, tm: _edge_residual(
            jnp.zeros(7), jnp.zeros(7), s[i], R[i], t[i], s[j], R[j], t[j],
            sm, Rm, tm))(g.ei, g.ej, g.s_m, g.R_m, g.t_m)
        return jnp.sum(g.w * jnp.sum(r * r, axis=-1))

    def linearize_solve(x, lam):
        s, R, t = x
        r, (Ji, Jj) = _res_and_jac(s[g.ei], R[g.ei], t[g.ei],
                                   s[g.ej], R[g.ej], t[g.ej],
                                   g.s_m, g.R_m, g.t_m)
        E = g.ei.shape[0]
        fac = lm.CamFactors(
            cam=jnp.stack([g.ei, g.ej], axis=-1),
            J=jnp.stack([Ji, Jj], axis=1),
            r=r,
            info=jnp.broadcast_to(jnp.eye(7, dtype=r.dtype), (E, 7, 7)),
            w=g.w)
        H = jnp.zeros((K, DC, K, DC), r.dtype)
        gv = jnp.zeros((K, DC), r.dtype)
        H, gv, _ = lm.accumulate_cam_factors(H, gv, jnp.zeros((), r.dtype), fac, g.free)
        dx = lm.solve_cam_system(H, gv, lam, g.free)
        if fix_scale:
            dx = dx.at[:, 6].set(0.0)
        return dx

    def retract(x, dx):
        s, R, t = x
        ds, dR, dt = lie.sim3_exp(dx)
        return lie.sim3_mul(ds, dR, dt, s, R, t)

    (s, R, t), cost, _ = lm.lm_optimize((g.s, g.R, g.t), linearize_solve, retract,
                                        cost_fn, iters, lam0=lam0)
    return lie.so3_normalize_fast(R), s, t, cost


def correct_map_points(mp_pos, mp_ref_kf, s_old, R_old, t_old, s_new, R_new, t_new):
    """Move each map point with its reference keyframe's Sim3 correction
    (CorrectLoop's point remap + OptimizeEssentialGraph's post-correction,
    src/LoopClosing.cpp:569-639 / src/Optimizer.cpp:4529-4560):
    X' = S_new^{-1} ( S_old ( X ) ), using that KF's world->kf transforms."""
    r = mp_ref_kf
    Xk = lie.sim3_apply(s_old[r], R_old[r], t_old[r], mp_pos)
    si, Ri, ti = lie.sim3_inv(s_new[r], R_new[r], t_new[r])
    return lie.sim3_apply(si, Ri, ti, Xk)
