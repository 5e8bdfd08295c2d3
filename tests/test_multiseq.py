"""Cross-sequence batched tracking: vmapped step == per-sequence step, and the
sequence axis shards across an 8-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam.camera import make_camera
from mc_slam.frontend import extractor
from mc_slam.frontend.orb import unpack_pm1
from mc_slam.parallel import multiseq
from mc_slam.pipeline import tracking
from mc_slam.slam_map.mapstate import empty_map
from mc_slam.solver import factors

from render import DotWorld

CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
EXT = factors.identity_extrinsics()


def make_seq(rng, seed_off):
    world = DotWorld(np.random.default_rng(seed_off), n_wall=300, n_front=80)
    m = empty_map(max_kf=4, max_mp=512, n_feat=256)
    # populate with the world's true points + descriptors from a rendered view
    img = world.render(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    f = extractor.extract(jnp.asarray(img), n_features=256, n_levels=3)
    # associate features to nearest world points by projection
    uv = np.asarray(f.xy)
    n = min(380, world.pts.shape[0])
    pc = world.pts[:n]
    proj = np.stack([300 * pc[:, 0] / pc[:, 2] + 240, 300 * pc[:, 1] / pc[:, 2] + 180], 1)
    dist = np.linalg.norm(pc, axis=1).astype(np.float32)
    m = m._replace(
        mp_pos=m.mp_pos.at[:n].set(jnp.asarray(pc)),
        mp_active=m.mp_active.at[:n].set(True),
        # scale range anchored at the creation distance so the predicted
        # pyramid level is ~0 (as SlamSystem sets it)
        mp_min_dist=m.mp_min_dist.at[:n].set(jnp.asarray(dist / 1.2**3)),
        mp_max_dist=m.mp_max_dist.at[:n].set(jnp.asarray(dist)))
    # give each map point the descriptor of its nearest feature (crude but valid)
    d = np.linalg.norm(proj[:, None, :] - uv[None, :, :], axis=2)
    nearest = d.argmin(1)
    m = m._replace(mp_pm1=m.mp_pm1.at[:n].set(f.desc_pm1[nearest]))
    img1 = world.render(np.eye(3, dtype=np.float32),
                        np.asarray([0.05, 0.02, 0.0], np.float32))
    return m, jnp.asarray(img1)


def test_batched_equals_individual(rng):
    B = 4
    maps, imgs = [], []
    for b in range(B):
        m, img = make_seq(rng, b)
        maps.append(m)
        imgs.append(img)
    ms = multiseq.stack_maps(maps)
    imgs_b = jnp.stack(imgs)
    P0 = jnp.zeros((B, 3))
    R0 = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
    step = multiseq.make_batched_step(CAM, EXT, n_features=256, n_levels=3)
    P, R, fmp, n_in = step(ms, imgs_b, P0, R0)
    assert P.shape == (B, 3)
    # individual runs match
    for b in range(B):
        f = extractor.extract(imgs[b], n_features=256, n_levels=3)
        r = tracking.track_frame_visual(maps[b], f, f.xy, CAM, EXT,
                                        jnp.zeros(3), jnp.eye(3), iters=10)
        # vmap changes f32 reduction order; equality is to ~1e-4
        np.testing.assert_allclose(np.asarray(P[b]), np.asarray(r.P), atol=1e-3)
        assert abs(int(n_in[b]) - int(r.n_inliers)) <= 2
        # liveness floor: the rotation-consistency prune (wired in round 2)
        # drops a couple of noisy-IC-angle dot matches vs round 1's 20+
        assert int(n_in[b]) > 15  # each sequence genuinely tracked


def test_sharded_over_mesh(rng):
    B = 8
    maps, imgs = [], []
    for b in range(B):
        m, img = make_seq(rng, 100 + b)
        maps.append(m)
        imgs.append(img)
    ms = multiseq.stack_maps(maps)
    imgs_b = jnp.stack(imgs)
    P0 = jnp.zeros((B, 3))
    R0 = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
    mesh = multiseq.make_seq_mesh(8)
    step = multiseq.make_batched_step(CAM, EXT, n_features=256, n_levels=3,
                                      mesh=mesh)
    P, R, fmp, n_in = step(ms, imgs_b, P0, R0)
    assert np.all(np.asarray(n_in) > 10)
    assert np.all(np.isfinite(np.asarray(P)))
