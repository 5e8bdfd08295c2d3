"""IO tests: EuRoC reader, native C++ loader parity, trajectory round-trips,
ATE oracle sanity."""
import numpy as np
import pytest

from mc_slam.eval.ate import ate_rmse, horn_align
from mc_slam.io import euroc, trajectory


@pytest.fixture(scope="module")
def fake_euroc(tmp_path_factory):
    """Build a miniature ASL-format dataset with PIL-encoded PNGs."""
    from PIL import Image
    root = tmp_path_factory.mktemp("euroc") / "mav0"
    (root / "cam0" / "data").mkdir(parents=True)
    (root / "imu0").mkdir(parents=True)
    rng = np.random.default_rng(0)
    t0 = 1403636579763555584
    with open(root / "cam0" / "data.csv", "w") as f:
        f.write("#ts,filename\n")
        for i in range(10):
            ns = t0 + int(i * 0.05 * 1e9)
            img = rng.integers(0, 255, (480, 752), dtype=np.uint8)
            Image.fromarray(img, "L").save(root / "cam0" / "data" / f"{ns}.png")
            f.write(f"{ns},{ns}.png\n")
    with open(root / "imu0" / "data.csv", "w") as f:
        f.write("#ts,wx,wy,wz,ax,ay,az\n")
        for i in range(100):
            ns = t0 + int(i * 0.005 * 1e9)
            v = rng.normal(size=6)
            f.write(f"{ns}," + ",".join(f"{x:.6f}" for x in v) + "\n")
    return str(root)


def test_euroc_reader(fake_euroc):
    seq = euroc.load_sequence(fake_euroc)
    assert len(seq.image_paths) == 10
    assert seq.imu.shape == (100, 7)
    frames = list(euroc.slice_imu_per_frame(seq))
    assert len(frames) == 10
    # strict `< t_frame` slicing: ~10 IMU rows per 0.05 s at 200 Hz
    counts = [f[2].shape[0] for f in frames[1:]]
    assert all(8 <= c <= 12 for c in counts), counts


def test_native_loader_parity(fake_euroc):
    from mc_slam.io import native_loader
    L = native_loader.NativeEurocLoader(fake_euroc)   # builds the library
    seq = euroc.load_sequence(fake_euroc)
    py = list(euroc.slice_imu_per_frame(seq))
    n = 0
    for (t, img, imu), (tp, path, imup) in zip(L, py):
        assert abs(t - tp) < 1e-9
        ref = euroc.load_gray_image(path)
        np.testing.assert_array_equal(img, ref)  # bit-exact PNG decode
        assert imu.shape[0] == imup.shape[0]
        if imu.shape[0]:
            np.testing.assert_allclose(imu[:, :6], imup[:, :6], atol=1e-6)
        n += 1
    assert n == 10


def test_trajectory_roundtrip(tmp_path, rng):
    from mc_slam import lie
    import jax.numpy as jnp
    traj = []
    for i in range(5):
        R = np.asarray(lie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5, jnp.float32)))
        traj.append((float(i), rng.normal(size=3).astype(np.float32), R))
    p = tmp_path / "t.txt"
    trajectory.save_tum(str(p), traj)
    ts, Ps, qs = trajectory.load_tum(str(p))
    np.testing.assert_allclose(ts, np.arange(5))
    np.testing.assert_allclose(Ps, np.stack([t[1] for t in traj]), atol=1e-6)
    # quaternions normalized
    np.testing.assert_allclose(np.linalg.norm(qs, axis=1), 1.0, atol=1e-5)


def test_ate_oracle(rng):
    P = rng.normal(size=(50, 3))
    t = np.arange(50) * 0.1
    # apply a known similarity + noise
    s, ang = 2.0, 0.4
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    Pg = s * P @ R.T + [1, -2, 3] + rng.normal(size=(50, 3)) * 0.01
    stats = ate_rmse(t, P, t, Pg, with_scale=True)
    assert stats["rmse"] < 0.02
    np.testing.assert_allclose(stats["scale"], 2.0, rtol=0.01)
    # rigid alignment cannot absorb the scale
    stats_r = ate_rmse(t, P, t, Pg, with_scale=False)
    assert stats_r["rmse"] > 0.5


def test_stream_driver_backpressure_and_imu_carry(rng):
    """StreamDriver drops frames when the pipeline is saturated but carries
    their IMU rows into the next processed frame (ros_vio back-pressure
    analog, Examples/ROS/VIO/src/ros_vio.cpp:156-166)."""
    import jax.numpy as jnp
    from mc_slam.camera import make_camera
    from mc_slam.io.stream import StreamDriver
    from mc_slam.pipeline.system import SlamConfig, SlamSystem

    cam = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
    slam = SlamSystem(cam, SlamConfig(max_kf=16, max_mp=512, n_feat=64,
                                      n_levels=2, use_imu=True))
    drv = StreamDriver(slam)
    seen = []
    orig_track = slam.track

    def rec_track(img, t, imu=None, **kw):
        seen.append((t, 0 if imu is None else len(imu)))
        return True                      # don't run the real pipeline
    slam.track = rec_track

    imu1 = np.zeros((5, 7), np.float32)
    img = rng.uniform(0, 255, (360, 480)).astype(np.float32)
    assert drv.on_frame(0.0, img, imu=None)
    # saturate the pipeline: pendings full
    slam._pendings.extend({} for _ in range(slam.LAG_MAX))
    assert not drv.accepting()
    assert not drv.on_frame(0.05, img, imu=imu1)
    assert not drv.on_frame(0.10, img, imu=imu1)
    assert drv.n_dropped == 2
    # pipeline drains; the next frame carries BOTH dropped frames' IMU
    slam._pendings.clear()
    assert drv.on_frame(0.15, img, imu=imu1)
    assert seen[-1] == (0.15, 15)
    assert drv.n_processed == 2
    slam.track = orig_track
