"""Headless visualization smoke tests (Viewer/MapDrawer/FrameDrawer analog)."""
import os

import jax.numpy as jnp
import numpy as np

from mc_slam.slam_map.mapstate import empty_map
from mc_slam.viz import render_frame_overlay, save_map_snapshot


def test_map_snapshot_renders(tmp_path, rng):
    K, F, P = 8, 32, 256
    m = empty_map(max_kf=K, max_mp=P, n_feat=F)
    kf_mp = rng.integers(-1, P, size=(K, F)).astype(np.int32)
    ns = m.kf_ns
    m = m._replace(
        kf_active=jnp.ones(K, bool),
        kf_feat_valid=jnp.ones((K, F), bool),
        kf_mp=jnp.asarray(kf_mp),
        kf_ns=ns._replace(P=jnp.asarray(rng.normal(0, 1, (K, 3)), jnp.float32)),
        mp_pos=jnp.asarray(rng.normal(0, 3, (P, 3)), jnp.float32),
        mp_active=jnp.ones(P, bool),
    )
    traj = [(0.1 * i, rng.normal(0, 1, 3), np.eye(3)) for i in range(20)]
    out = save_map_snapshot(m, traj, str(tmp_path / "map.png"),
                            covis_min_weight=1, title="test map")
    assert os.path.getsize(out) > 10_000


def test_frame_overlay_renders(tmp_path, rng):
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xy = rng.uniform(0, 150, (64, 2)).astype(np.float32)
    valid = rng.uniform(size=64) > 0.2
    matched = rng.uniform(size=64) > 0.5
    out = render_frame_overlay(img, xy, valid, matched,
                               str(tmp_path / "frame.png"), title="frame 0")
    assert os.path.getsize(out) > 5_000
