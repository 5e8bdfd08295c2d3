"""Distributed bundle adjustment: landmark-sharded Schur reduction over a mesh.

This is the BASELINE.json north-star component (SURVEY.md sections 2.4/5):
the reference has NO distributed layer (pthreads over one shared map, see
CMakeLists.txt:26-82 — no NCCL/MPI); this design is new:

  * landmarks and their observations are sharded across devices on a 1-D mesh
    axis "mp" (each observation touches exactly one landmark, so partitioning
    obs by landmark makes the landmark system embarrassingly parallel);
  * every device builds its partial camera system H_cc, g_c and its partial
    Schur correction Y W^T from its landmark shard;
  * one `psum` over the mesh reduces the dense camera-camera system (the only
    cross-device communication, a collective over NVLink on GPUs);
  * the reduced solve is replicated (small dense Cholesky), and landmark
    back-substitution is local to each shard.

The same function runs single-device when the mesh has one entry.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mc_slam import lie
from mc_slam.solver import lm


def make_mesh(n_devices=None, axis="mp"):
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(devs, (axis,))


def shard_ba_problem(mesh, obs: lm.Observations, Np):
    """Place observation arrays on the mesh sharded by their leading (obs) dim.
    Caller must pre-sort observations by landmark and pad so that obs of the
    same landmark never straddle a shard boundary AND landmark blocks divide
    evenly — easiest recipe: pad landmarks to a multiple of n_devices and give
    each landmark a fixed max-obs budget."""
    spec = P("mp")
    put = lambda x: jax.device_put(x, NamedSharding(mesh, spec))
    return lm.Observations(
        cam=put(obs.cam), pt=put(obs.pt), Jc=put(obs.Jc), Jp=put(obs.Jp),
        r=put(obs.r), w=put(obs.w))


def dist_schur_solve(mesh, obs: lm.Observations, cam_H, cam_g, free_mask,
                     pt_mask, lam, Nc, DC, Np, DP):
    """One damped Schur solve with landmark shards.

    obs: sharded by observation dim; obs.pt holds GLOBAL landmark indices and
    each shard only references its own landmark range. cam_H/cam_g: replicated
    camera-only factor system (IMU chain etc.) to add to the reduced system.
    Returns (dxc replicated, dxp sharded by landmark).
    """
    n_dev = mesh.devices.size
    Np_local = Np // n_dev

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("mp"), P("mp"), P("mp"), P("mp"), P("mp"), P("mp"),
                       P(), P(), P(), P("mp"), P()),
             out_specs=(P(), P("mp")))
    def step(o_cam, o_pt, o_Jc, o_Jp, o_r, o_w, Hc, gc, fm, ptm, lam):
        shard = jax.lax.axis_index("mp")
        pt_local = o_pt - shard * Np_local
        o = lm.Observations(cam=o_cam, pt=jnp.clip(pt_local, 0, Np_local - 1),
                            Jc=o_Jc, Jp=o_Jp, r=o_r,
                            w=o_w * (pt_local >= 0) * (pt_local < Np_local))
        Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(
            o, fm, Nc, DC, Np_local, DP)
        # local landmark inverses + partial Schur pieces
        eyep = jnp.eye(DP, dtype=Hpp.dtype)
        Hpp_d = Hpp + lam * (Hpp * eyep) + 1e-8 * eyep
        Hpp_inv = lm.batched_inv_small(Hpp_d)
        Y = jnp.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)
        S_part = Hcc - jnp.einsum('cipk,djpk->cidj', Y, Wcp)
        g_part = g_c - jnp.einsum('cipk,pk->ci', Y, g_p)
        # ONE collective: reduce the dense camera system over the mesh
        # (stack S with the Hcc diagonal so a single psum moves everything)
        n = Nc * DC
        diag_part = jnp.diagonal(Hcc.reshape(n, n))
        S, g_s, diag_c = jax.lax.psum((S_part, g_part, diag_part), "mp")
        S = S + Hc
        g_s = g_s + gc
        diag_c = diag_c + jnp.diagonal(Hc.reshape(n, n))
        # replicated reduced solve — damping on the raw Hcc diagonal, exactly
        # as the single-device lm.schur_solve
        Sf = S.reshape(n, n)
        Sf = Sf + jnp.diag(lam * diag_c + 1e-10)
        fmr = jnp.repeat(fm, DC)
        Sf = Sf * fmr[:, None] * fmr[None, :] + jnp.diag(1.0 - fmr)
        L, low = jax.scipy.linalg.cho_factor(Sf, lower=True)
        dxc = jax.scipy.linalg.cho_solve((L, low), -(g_s.reshape(n) * fmr)).reshape(Nc, DC)
        # local landmark back-substitution
        rhs = g_p + jnp.einsum('cipj,ci->pj', Wcp, dxc)
        dxp = -jnp.einsum('pjk,pk->pj', Hpp_inv, rhs) * ptm[:, None]
        return dxc, dxp

    return step(obs.cam, obs.pt, obs.Jc, obs.Jp, obs.r, obs.w,
                cam_H, cam_g, free_mask, pt_mask, jnp.asarray(lam))
