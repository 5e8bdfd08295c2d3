#!/usr/bin/env python
"""EuRoC driver: the mono_EuRoC_vins equivalent
(Examples/Monocular/mono_EuRoC_vins.cc).

Usage:
  python examples/run_euroc.py /path/to/MH_01_easy/mav0 [--no-imu] \
      [--out-dir out/] [--max-frames N] [--gt path/to/state_groundtruth]

Loads the ASL folder, slices IMU strictly before each frame timestamp, feeds
SlamSystem, reports per-frame median/mean track time at exit (driver :231-232),
writes frame + keyframe trajectories (TUM + NavState formats) and, when ground
truth is given, the Horn-aligned ATE (evaluate_ate.py parity).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mav0")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--gt", default="")
    ap.add_argument("--n-feat", type=int, default=1024)
    ap.add_argument("--profile", choices=["euroc", "small"], default="euroc",
                    help="small: reduced capacities/levels for CPU smoke runs")
    args = ap.parse_args()

    import jax.numpy as jnp
    from mc_slam.camera import euroc_camera
    from mc_slam.eval.ate import ate_rmse
    from mc_slam.io import euroc, trajectory
    from mc_slam.pipeline.system import SlamConfig, SlamSystem

    # EuRoC Tbc (config/euroc.yaml:40-44)
    Tbc = np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0]], np.float32)

    seq = euroc.load_sequence(args.mav0)
    cam = euroc_camera()
    if args.profile == "small":
        cfg = SlamConfig(max_kf=64, max_mp=4096, n_feat=min(args.n_feat, 512),
                         n_levels=3, local_window=8, use_imu=not args.no_imu,
                         vi_init_time=5.0, g_mag=9.810)
    else:
        cfg = SlamConfig(max_kf=512, max_mp=16384, n_feat=args.n_feat, n_levels=8,
                         local_window=20, use_imu=not args.no_imu,
                         vi_init_time=15.0, g_mag=9.810)
    slam = SlamSystem(cam, cfg, Tbc=None if args.no_imu else Tbc)

    from mc_slam.io import native_loader

    def frames():
        yield from native_loader.NativeEurocLoader(args.mav0)

    times = []
    n = 0

    def run_frame(item):
        nonlocal n
        t_frame, buf, imu_rows = item
        t0 = time.perf_counter()
        slam.track(buf, t_frame, imu=None if args.no_imu else imu_rows)
        times.append(time.perf_counter() - t0)
        n += 1
        if n % 100 == 0:
            print(f"frame {n}: state={slam.state} kf={slam.n_kf} "
                  f"mp={int(slam.m.mp_active.sum())} "
                  f"median_track={np.median(times)*1e3:.1f}ms", file=sys.stderr)

    # one-frame lookahead: upload frame n+1 (async, uint8) before tracking
    # frame n so the host->device transfer overlaps tracking compute
    pending = None
    for t_frame, img, imu_rows in frames():
        buf = slam.upload(img)
        if pending is not None:
            run_frame(pending)
            if args.max_frames and n >= args.max_frames:
                pending = None
                break
        pending = (t_frame, buf, imu_rows)
    if pending is not None:
        run_frame(pending)

    os.makedirs(args.out_dir, exist_ok=True)
    traj = slam.get_trajectory()
    trajectory.save_tum(os.path.join(args.out_dir, "FrameTrajectory_TUM.txt"), traj)
    # keyframe trajectory + NavState dump
    kf_entries = []
    for s in slam.kf_slots:
        ns = slam.m.kf_ns
        kf_entries.append((float(slam.m.kf_time[s]), np.asarray(ns.P[s]),
                           np.asarray(ns.R[s]), np.asarray(ns.V[s]),
                           np.asarray(ns.bg[s] + ns.dbg[s]),
                           np.asarray(ns.ba[s] + ns.dba[s])))
    trajectory.save_tum(os.path.join(args.out_dir, "KeyFrameTrajectory_TUM.txt"),
                        [(t, P, R) for t, P, R, *_ in kf_entries])
    trajectory.save_navstate(
        os.path.join(args.out_dir, "KeyFrameNavStateTrajectory.txt"), kf_entries)

    print(f"median track time: {np.median(times)*1e3:.2f} ms  "
          f"mean: {np.mean(times)*1e3:.2f} ms")
    result = {"frames": n, "keyframes": slam.n_kf,
              "median_track_ms": float(np.median(times) * 1e3),
              "fps": float(1.0 / np.median(times))}

    if args.gt:
        gt = np.loadtxt(args.gt, delimiter=",", comments="#")
        t_gt = gt[:, 0] / 1e9
        P_gt = gt[:, 1:4]
        t_est = np.asarray([x[0] for x in traj])
        P_est = np.asarray([x[1] for x in traj])
        stats = ate_rmse(t_est, P_est, t_gt, P_gt,
                         with_scale=args.no_imu or not slam.vi_inited)
        print("ATE:", stats)
        result["ate_rmse"] = stats["rmse"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
