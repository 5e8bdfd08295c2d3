"""End-to-end monocular vision-only SLAM on rendered synthetic frames
(SURVEY.md section 7 step 5 gate: the minimum slice, scored by Horn-aligned ATE)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_slam import lie
from mc_slam.camera import make_camera
from mc_slam.eval.ate import ate_rmse
from mc_slam.pipeline.system import SlamConfig, SlamSystem, OK

from render import DotWorld

CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)


def camera_pose(t):
    """Slow lateral arc with small yaw, looking at the wall."""
    P = np.array([0.8 * np.sin(0.4 * t), 0.15 * np.sin(0.3 * t), 0.25 * t * 0.2])
    yaw = 0.08 * np.sin(0.5 * t)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    return P.astype(np.float32), R.astype(np.float32)


@pytest.mark.slow
def test_visual_slam_tracks_sequence(rng):
    world = DotWorld(rng)
    cfg = SlamConfig(max_kf=64, max_mp=2048, n_feat=384, n_levels=3,
                     min_init_matches=50)
    sys = SlamSystem(CAM, cfg)
    n_frames, dt = 40, 0.1
    gts = []
    n_ok = 0
    for i in range(n_frames):
        t = i * dt
        P, R = camera_pose(t)
        img = world.render(R, P)
        ok = sys.track(img, t)
        gts.append((t, P))
        n_ok += int(ok)
    assert sys.state == OK
    assert n_ok > 0.8 * (n_frames - 2), f"tracked {n_ok}/{n_frames}"

    traj = sys.get_trajectory()
    assert len(traj) > 0.8 * n_frames
    t_est = np.asarray([x[0] for x in traj])
    P_est = np.asarray([x[1] for x in traj])
    t_gt = np.asarray([g[0] for g in gts])
    P_gt = np.asarray([g[1] for g in gts])
    stats = ate_rmse(t_est, P_est, t_gt, P_gt, with_scale=True)
    # path length ~ 2 m; demand cm-level ATE after Sim3 alignment
    assert stats["rmse"] < 0.05, stats
    # map grew beyond the bootstrap points
    assert int(sys.m.mp_active.sum()) > 100
    assert sys.n_kf >= 3
