#!/usr/bin/env python
"""Full-length end-to-end evaluation on the synthetic EuRoC clone.

Generates (if missing) a clone dataset under .data/, runs the complete VI
pipeline at the chosen profile through mc_slam.eval.clone.run_clone (the
same path bench.py and chip_smoke.py drive), scores ATE against ground truth
(evaluate_ate.py parity), and writes the result JSON. The output names the
device the run used.

  python examples/eval_clone.py [--profile euroc] [--platform cpu]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mc_slam.eval import clone  # noqa: E402
from mc_slam.runtime import CHECKOUT  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="clone length [s]; 0 = the profile's default")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--profile", choices=clone.PROFILES, default="euroc")
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="gpu (default) fails when JAX finds no GPU; cpu "
                         "runs on the host")
    ap.add_argument("--final-gba", action="store_true",
                    help="run one whole-map BA before scoring")
    ap.add_argument("--out", default="")
    ap.add_argument("--gate", action="store_true",
                    help="exit nonzero when accuracy/throughput regress past "
                         "the adopted thresholds (reference acceptance: "
                         "run.sh + evaluate_ate.py per-sequence bounds)")
    ap.add_argument("--gate-ate", type=float, default=0.15,
                    help="max post-init ATE RMSE [m]")
    ap.add_argument("--gate-scale", type=float, default=0.02,
                    help="max |1 - Sim3 scale|")
    ap.add_argument("--gate-fps", type=float, default=20.0,
                    help="min amortized e2e fps (ignored on cpu platform)")
    ap.add_argument("--gate-lost", type=int, default=60,
                    help="max lost frames")
    ap.add_argument("--no-loops", action="store_true",
                    help="disable loop closing (drift diagnosis)")
    ap.add_argument("--save-ckpt",
                    default=os.path.join(clone.DATA_DIR, "clone_ckpt.npz"),
                    help="system checkpoint for at-scale offline benches "
                         "(bench_scaling loads the REAL map); empty disables")
    # loop-closure demonstration: warp everything created after a cutoff by
    # a small per-frame SE3 step (gravity-preserving yaw + translation) during
    # [t0, t1] after VI init; pair with --no-loops for the healing comparison
    ap.add_argument("--inject-drift", action="store_true")
    ap.add_argument("--drift-window", type=float, nargs=2, default=[20.0, 50.0])
    ap.add_argument("--drift-step", type=float, nargs=4,
                    default=[3e-4, -2e-4, 2e-4, 1.5e-4],
                    help="per-frame [dx dy dz yaw]")
    args = ap.parse_args()
    duration = args.duration or clone.default_duration(args.profile)
    dataset = args.dataset or clone.dataset_dir(args.profile, duration)

    if not clone.has_dataset(dataset):
        print(f"generating clone dataset at {dataset}...", file=sys.stderr)
        clone.ensure_dataset(dataset, duration, args.profile)

    import jax
    from mc_slam import runtime
    if args.platform == "gpu":
        runtime.use_gpu()
        runtime.setup_compile_cache()
    else:
        jax.config.update("jax_platforms", "cpu")

    result = clone.run_clone(
        dataset, args.profile, max_frames=args.max_frames,
        no_loops=args.no_loops, final_gba=args.final_gba,
        save_ckpt=args.save_ckpt, art_dir=os.path.join(CHECKOUT, "artifacts"),
        inject_drift=args.inject_drift, drift_window=tuple(args.drift_window),
        drift_step=tuple(args.drift_step))
    result["duration_s"] = duration
    print(json.dumps(result))
    out = args.out or os.path.join(CHECKOUT, "artifacts", "ate_clone.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}", file=sys.stderr)
    if args.gate:
        on_accel = result["device"]["platform"] != "cpu"
        fails = clone.gate_failures(
            result, args.gate_ate, args.gate_scale, args.gate_lost,
            gate_fps=args.gate_fps if on_accel else None)
        if fails:
            print("GATE FAILED: " + "; ".join(fails), file=sys.stderr)
            sys.exit(1)
        print("GATE PASSED", file=sys.stderr)


if __name__ == "__main__":
    main()
