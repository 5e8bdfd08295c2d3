#!/usr/bin/env python
"""Generate a full-scale synthetic EuRoC clone (ASL folder) for end-to-end
validation: 752x480 distorted frames at 20 fps, 200 Hz IMU with EuRoC noise
densities (src/IMU/imudata.cpp:25-37) and non-zero biases, ground truth CSV.

The trajectory closes on itself (loop-closure opportunity) and the camera is
mounted with the real EuRoC Tbc. Run the result through examples/run_euroc.py:

  python examples/make_euroc_clone.py --out /tmp/clone --duration 120
  python examples/run_euroc.py /tmp/clone/mav0 \
      --gt /tmp/clone/mav0/state_groundtruth_estimate0/data.csv
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the reference's EuRoC Tbc (config/euroc.yaml:40-44)
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])


def o_list_step(occ, fdt, rng):
    """Advance drifting occluders; bounce at the frame edges."""
    for o in occ:
        o["uv"] = o["uv"] + o["vel"] * fdt
        for k in range(2):
            if not (0.0 <= o["uv"][k] <= 0.95):
                o["vel"][k] = -o["vel"][k]
                o["uv"][k] = np.clip(o["uv"][k], 0.0, 0.95)
    return occ


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/euroc_clone")
    ap.add_argument("--duration", type=float, default=120.0)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tex-size", type=int, default=2048)
    ap.add_argument("--tex-scale", type=float, default=1.0,
                    help="1.0 = non-periodic walls (repeating texture makes "
                         "the world self-aliased: false loop closures with "
                         "geometrically consistent 6 m errors, measured)")
    ap.add_argument("--bg", type=float, nargs=3, default=[0.003, -0.0045, 0.0035],
                    help="true gyro bias [rad/s]")
    ap.add_argument("--ba", type=float, nargs=3, default=[0.035, -0.02, 0.06],
                    help="true accel bias [m/s^2]")
    # photometric hardening: the rendered texture alone under-stresses the
    # front end vs real EuRoC footage — add the three dominant real-world
    # nuisances (motion blur from the rolling exposure, auto-exposure /
    # lighting flicker, and moving foreground occluders)
    ap.add_argument("--no-harden", dest="harden", action="store_false",
                    default=True)
    ap.add_argument("--blur-ms", type=float, default=12.0,
                    help="exposure window for motion blur [ms]")
    # --- robustness-envelope knobs (V1_02/MH_04-class profiles) ---
    ap.add_argument("--laps", type=int, default=1,
                    help="trajectory laps over the duration: the closed path "
                         "repeats N times (N-1 guaranteed revisits for loop "
                         "closure) and motion speed scales by N")
    ap.add_argument("--imu-noise-scale", type=float, default=1.0,
                    help="multiply the EuRoC noise densities (degraded "
                         "odometry -> real accumulated drift)")
    ap.add_argument("--yaw-scale", type=float, default=1.0,
                    help="scale the yaw-sweep amplitude (fast-rotation "
                         "stress, V1_03 analog)")
    ap.add_argument("--tex-contrast", type=float, default=1.0,
                    help="texture contrast multiplier (<1 = low-texture "
                         "stress)")
    ap.add_argument("--weak-walls", type=int, nargs="*", default=[],
                    help="plane indices (0..5: -x,+x,-y,+y,floor,ceiling) "
                         "rendered at --weak-contrast (feature-starved "
                         "sector; MH_04 dark-passage analog)")
    ap.add_argument("--weak-contrast", type=float, default=0.3)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from mc_slam.camera import euroc_camera
    from mc_slam.sim import MavTrajectory, RoomWorld
    from mc_slam.sim.euroc_writer import EurocWriter

    rng = np.random.default_rng(args.seed)
    cam = euroc_camera()
    world = RoomWorld(rng, tex_size=args.tex_size,
                      tex_scale=args.tex_scale,
                      weak_walls=tuple(args.weak_walls),
                      weak_contrast=args.weak_contrast)
    # laps > 1: the closed path's period is duration/laps, so the MAV re-flies
    # the same circuit (each revisit is a loop-closure opportunity, like the
    # repeated machine-hall passes of EuRoC MH sequences) at laps-x speed
    traj = MavTrajectory(duration=args.duration / max(args.laps, 1),
                         yaw_scale=args.yaw_scale)
    writer = EurocWriter(args.out)
    bg = np.asarray(args.bg)
    ba = np.asarray(args.ba)

    Rbc = TBC[:3, :3]
    pbc = TBC[:3, 3]

    n_frames = int(args.duration * args.fps)
    fdt = 1.0 / args.fps
    t_off = 100.0  # EuRoC-style large absolute timestamps
    t0 = time.time()
    # drifting foreground occluders (dark low-texture boxes)
    occ = [{"uv": rng.uniform(0.1, 0.9, 2), "vel": rng.uniform(-0.15, 0.15, 2),
            "wh": rng.uniform(0.06, 0.16, 2), "val": rng.uniform(15, 55)}
           for _ in range(2)]
    for i in range(n_frames):
        t = i * fdt
        P_wb, R_wb = traj.pose(t)
        R_wc = R_wb @ Rbc
        C_w = P_wb + R_wb @ pbc
        img = world.render(cam, R_wc, C_w)
        if args.harden:
            # motion blur: average the exposure window's start and end views
            P2, R2 = traj.pose(t + args.blur_ms * 1e-3)
            img2 = world.render(cam, R2 @ Rbc, P2 + R2 @ pbc)
            img = 0.5 * img.astype(np.float32) + 0.5 * img2.astype(np.float32)
        if args.tex_contrast != 1.0:
            img = np.clip(118.0 + args.tex_contrast
                          * (np.asarray(img, np.float32) - 118.0),
                          0, 255).astype(np.float32 if args.harden
                                         else np.uint8)
        if args.harden:
            # auto-exposure / lighting flicker
            gain = (1.0 + 0.12 * np.sin(2 * np.pi * 0.9 * t + 0.7)
                    + rng.normal(0.0, 0.02))
            img = img * gain + rng.normal(0.0, 1.5, img.shape)
            # moving occluders (~1-3% of pixels each)
            H_, W_ = img.shape
            for o in o_list_step(occ, fdt, rng):
                u0 = int(o["uv"][0] * W_); v0 = int(o["uv"][1] * H_)
                w_ = int(o["wh"][0] * W_); h_ = int(o["wh"][1] * H_)
                img[max(v0, 0):v0 + h_, max(u0, 0):u0 + w_] = (
                    o["val"] + rng.normal(0, 3.0, img[max(v0, 0):v0 + h_,
                                                      max(u0, 0):u0 + w_].shape))
            img = np.clip(img, 0, 255).astype(np.uint8)
        writer.add_image(t + t_off, img)
        writer.add_gt(t + t_off, P_wb, R_wb, traj.velocity(t), bg, ba)
        if i % 200 == 0:
            el = time.time() - t0
            print(f"frame {i}/{n_frames}  ({el:.0f}s elapsed)", file=sys.stderr)
    # IMU over the whole span (EuRoC noise densities, src/IMU/imudata.cpp)
    rows = traj.imu_samples(0.0, n_frames * fdt, rate=200.0, bg=bg, ba=ba,
                            noise_g=1.7e-4 * args.imu_noise_scale,
                            noise_a=2e-3 * args.imu_noise_scale, rng=rng)
    tt = t_off + np.arange(len(rows)) / 200.0
    for k in range(len(rows)):
        writer.add_imu(tt[k], rows[k, 0:3], rows[k, 3:6])
    gt_path = writer.finish()
    print(f"wrote {n_frames} frames + {len(rows)} IMU rows to {args.out}")
    print(f"gt: {gt_path}")


if __name__ == "__main__":
    main()
