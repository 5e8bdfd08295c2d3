"""NavState: the 15-DoF IMU navigation state as a JAX pytree.

Device-side equivalent of the reference's NavState (src/IMU/NavState.{h,cpp}):
{P, V, R in SO(3), bias_g, bias_a} plus delta-bias {dbg, dba} which the optimizers
update while the base bias stays fixed between relinearizations.

All fields broadcast over leading batch dims, so a whole keyframe table is one
NavState with arrays of shape (N, ...). Retractions mirror NavState::IncSmall*
(src/IMU/NavState.cpp:31-109): position/velocity/bias additive, rotation
right-multiplicative R <- R @ Exp(dphi).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mc_slam import lie


class NavState(NamedTuple):
    P: jnp.ndarray   # (..., 3) position of body in world
    V: jnp.ndarray   # (..., 3) velocity in world
    R: jnp.ndarray   # (..., 3, 3) world-from-body rotation
    bg: jnp.ndarray  # (..., 3) gyro bias (fixed linearization point)
    ba: jnp.ndarray  # (..., 3) accel bias
    dbg: jnp.ndarray  # (..., 3) delta gyro bias (optimized)
    dba: jnp.ndarray  # (..., 3) delta accel bias

    @property
    def bg_full(self):
        return self.bg + self.dbg

    @property
    def ba_full(self):
        return self.ba + self.dba


def navstate_identity(batch_shape=(), dtype=jnp.float32) -> NavState:
    z3 = jnp.zeros(batch_shape + (3,), dtype)
    I = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
    return NavState(P=z3, V=z3, R=I, bg=z3, ba=z3, dbg=z3, dba=z3)


def inc_small(ns: NavState, upd) -> NavState:
    """15d update [dP, dV, dPhi, ddbg, ddba] (NavState::IncSmall ordering)."""
    return ns._replace(
        P=ns.P + upd[..., 0:3],
        V=ns.V + upd[..., 3:6],
        R=ns.R @ lie.so3_exp(upd[..., 6:9]),
        dbg=ns.dbg + upd[..., 9:12],
        dba=ns.dba + upd[..., 12:15],
    )


def inc_small_pvr(ns: NavState, upd) -> NavState:
    """9d update [dP, dV, dPhi]."""
    return ns._replace(
        P=ns.P + upd[..., 0:3],
        V=ns.V + upd[..., 3:6],
        R=ns.R @ lie.so3_exp(upd[..., 6:9]),
    )


def inc_small_pr(ns: NavState, upd) -> NavState:
    """6d update [dP, dPhi]."""
    return ns._replace(
        P=ns.P + upd[..., 0:3],
        R=ns.R @ lie.so3_exp(upd[..., 3:6]),
    )


def inc_small_bias(ns: NavState, upd) -> NavState:
    """6d update [ddbg, ddba]."""
    return ns._replace(dbg=ns.dbg + upd[..., 0:3], dba=ns.dba + upd[..., 3:6])
