"""Cross-sequence batching: track B sequences as one vmapped device program.

BASELINE.json config #4 ("all 11 EuRoC sequences batched on one host, keyframe
blocks sharded across chips"): every per-frame kernel is already fixed-shape,
so a batch of per-sequence MapStates is just a leading axis, and scale-out
across chips is a NamedSharding on that axis (pure data parallelism — each
sequence's map lives on one device; no cross-device traffic in the hot loop).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mc_slam.frontend import extractor
from mc_slam.pipeline import tracking


def stack_maps(maps):
    """List of per-sequence MapState -> batched MapState (B, ...)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *maps)


def make_batched_step(cam, ext, n_features=1024, n_levels=8, iters=10,
                      mesh: Mesh | None = None):
    """Build a jitted (optionally sharded) batched extract+track step.

    With a mesh, the sequence axis is sharded across devices ("seq" data
    parallelism); without, the batch runs on one device.
    """
    # extract and track are SEPARATE jitted dispatches: fusing them into one
    # vmapped program blows up XLA compile time, and the batched
    # scatter/top-k extractor epilogue and the matmul-heavy matcher/LM want
    # different fusion layouts. Two dispatches cost one extra launch.
    ex = jax.jit(jax.vmap(
        lambda img: extractor.extract(img, n_features=n_features,
                                      n_levels=n_levels)))
    tr = jax.jit(jax.vmap(
        lambda m, f, P0, R0: tracking.track_frame_visual(
            m, f, f.xy, cam, ext, P0, R0, iters=iters)))

    def step(ms, imgs, P0s, R0s):
        f = ex(imgs)
        r = tr(ms, f, P0s, R0s)
        return r.P, r.R, r.feat_mp, r.n_inliers

    if mesh is None:
        return step

    shard = NamedSharding(mesh, P("seq"))

    def sharded_step(ms, imgs, P0s, R0s):
        ms = jax.tree_util.tree_map(lambda a: jax.device_put(a, shard), ms)
        imgs = jax.device_put(imgs, shard)
        P0s = jax.device_put(P0s, shard)
        R0s = jax.device_put(R0s, shard)
        return step(ms, imgs, P0s, R0s)

    return sharded_step


def make_seq_mesh(n_devices=None):
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(devs, ("seq",))
