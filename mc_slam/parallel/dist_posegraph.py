"""Distributed Sim3/SE3 pose-graph optimization: edge-sharded LM over a mesh.

Same recipe as dist_ba.py, applied to the essential-graph problem
(Optimizer::OptimizeEssentialGraph math, src/Optimizer.cpp:4243-4578 — the
reference runs it single-threaded; the mesh decomposition is new):

  * pose-graph edges (loop / spanning-tree / covisibility) are sharded across
    devices on a 1-D mesh axis "e";
  * every device evaluates residual+Jacobian for its edge shard and accumulates
    its partial dense vertex system H (K,7,K,7), g;
  * ONE `psum` reduces the vertex system (the only cross-device communication);
  * the reduced solve and the LM accept/reject loop run replicated, so every
    device steps the same vertex state in lockstep.

The entire LM loop lives inside a single shard_map-jitted program — no
host round-trips between iterations.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mc_slam import lie
from mc_slam.solver import lm
from mc_slam.solver.posegraph import Sim3Graph, _res_and_jac, _edge_residual


def pad_graph_edges(g: Sim3Graph, n_devices: int) -> Sim3Graph:
    """Pad edge arrays so the edge count divides the mesh size (padded edges
    carry w=0 and reference vertex 0)."""
    E = g.ei.shape[0]
    Ep = ((E + n_devices - 1) // n_devices) * n_devices
    if Ep == E:
        return g
    pad = Ep - E
    z = jnp.zeros(pad, g.ei.dtype)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=g.R_m.dtype), (pad, 3, 3))
    return g._replace(
        ei=jnp.concatenate([g.ei, z]),
        ej=jnp.concatenate([g.ej, z]),
        s_m=jnp.concatenate([g.s_m, jnp.ones(pad, g.s_m.dtype)]),
        R_m=jnp.concatenate([g.R_m, eye]),
        t_m=jnp.concatenate([g.t_m, jnp.zeros((pad, 3), g.t_m.dtype)]),
        w=jnp.concatenate([g.w, jnp.zeros(pad, g.w.dtype)]))


def optimize_pose_graph_dist(mesh: Mesh, g: Sim3Graph, iters: int = 20,
                             lam0: float = 1e-8, fix_scale: bool = False,
                             axis: str = "e"):
    """Edge-sharded pose-graph LM. Returns (R, s, t, cost) like the
    single-device optimize_pose_graph; vertices replicated on every device."""
    n_dev = mesh.devices.size
    g = pad_graph_edges(g, n_dev)
    K = g.s.shape[0]
    DC = 7
    spec_e = P(axis)
    spec_r = P()

    @partial(jax.jit, static_argnames=())
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_r, spec_r, spec_r, spec_e, spec_e, spec_e, spec_e,
                       spec_e, spec_e, spec_r),
             out_specs=(spec_r, spec_r, spec_r, spec_r))
    def run(s0, R0, t0, ei, ej, s_m, R_m, t_m, w, free):
        E_loc = ei.shape[0]

        def cost_fn(x):
            s, R, t = x
            r = jax.vmap(lambda i, j, sm, Rm, tm: _edge_residual(
                jnp.zeros(7), jnp.zeros(7), s[i], R[i], t[i], s[j], R[j], t[j],
                sm, Rm, tm))(ei, ej, s_m, R_m, t_m)
            c = jnp.sum(w * jnp.sum(r * r, axis=-1))
            return jax.lax.psum(c, axis)

        def linearize_solve(x, lam):
            s, R, t = x
            r, (Ji, Jj) = _res_and_jac(s[ei], R[ei], t[ei],
                                       s[ej], R[ej], t[ej], s_m, R_m, t_m)
            fac = lm.CamFactors(
                cam=jnp.stack([ei, ej], axis=-1),
                J=jnp.stack([Ji, Jj], axis=1),
                r=r,
                info=jnp.broadcast_to(jnp.eye(7, dtype=r.dtype), (E_loc, 7, 7)),
                w=w)
            H = jnp.zeros((K, DC, K, DC), r.dtype)
            gv = jnp.zeros((K, DC), r.dtype)
            H, gv, _ = lm.accumulate_cam_factors(
                H, gv, jnp.zeros((), r.dtype), fac, free)
            # ONE collective: reduce the dense vertex system over the mesh
            H, gv = jax.lax.psum((H, gv), axis)
            dx = lm.solve_cam_system(H, gv, lam, free)
            if fix_scale:
                dx = dx.at[:, 6].set(0.0)
            return dx

        def retract(x, dx):
            s, R, t = x
            ds, dR, dt = lie.sim3_exp(dx)
            return lie.sim3_mul(ds, dR, dt, s, R, t)

        (s, R, t), cost, _ = lm.lm_optimize(
            (s0, R0, t0), linearize_solve, retract, cost_fn, iters, lam0=lam0)
        return s, lie.so3_normalize_fast(R), t, cost

    put_e = lambda x: jax.device_put(x, NamedSharding(mesh, spec_e))
    put_r = lambda x: jax.device_put(x, NamedSharding(mesh, spec_r))
    s, R, t, cost = run(put_r(g.s), put_r(g.R), put_r(g.t),
                        put_e(g.ei), put_e(g.ej), put_e(g.s_m), put_e(g.R_m),
                        put_e(g.t_m), put_e(g.w), put_r(g.free))
    return R, s, t, cost
