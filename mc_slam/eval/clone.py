"""End-to-end run of the full VI pipeline on a synthetic EuRoC clone.

One function, `run_clone`, drives `SlamSystem.track` over a clone dataset
made by examples/make_euroc_clone.py and scores the trajectory against ground
truth (evaluate_ate.py parity). examples/eval_clone.py, bench.py and
chip_smoke.py all call it, so every end-to-end number comes from the same
code path. Datasets live under `<checkout>/.data` (git-ignored) and are
generated in a child process that stays on the CPU.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

import numpy as np

from mc_slam.runtime import CHECKOUT

# the reference's EuRoC Tbc (config/euroc.yaml:40-44)
TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]], np.float32)

PROFILES = ("euroc", "mid", "small", "loops", "hard")
DATA_DIR = os.path.join(CHECKOUT, ".data")

# per-profile dataset generation (make_euroc_clone.py args): the robustness
# envelope mirrors config/euroc.yaml:18-20's sequence-quality spread —
#   euroc/mid/small: the baseline MH-easy-like circuit;
#   loops: 2 laps of the circuit with 6x IMU noise and weak-texture sectors
#          (degraded odometry -> real accumulated drift; each revisit is a
#          closure opportunity — MH_03-medium analog);
#   hard:  2 laps at 2x speed, 1.6x yaw sweep, 25 ms blur, 0.55x contrast
#          (fast-rotation/low-texture stress — V1_03-difficult analog; the
#          gate is survival/relocalization, not accuracy).
PROFILE_GEN = {
    "loops": ["--laps", "2", "--imu-noise-scale", "6",
              "--weak-walls", "1", "3", "--weak-contrast", "0.45"],
    "hard": ["--laps", "2", "--yaw-scale", "1.6", "--blur-ms", "25",
             "--tex-contrast", "0.55"],
}
# loops: 2 laps at the BASELINE circuit speed (240 s total — the 2x-speed
# 120 s variant loses tracking on the fast ceiling sweep regardless of
# texture, exactly like the reference's V2_03 'lost'); hard keeps the fast
# variant as the stress row.
PROFILE_DURATION = {"loops": 240.0, "hard": 60.0}


def profile_config(profile):
    """SlamConfig of a deployment profile."""
    from mc_slam.pipeline.system import SlamConfig
    if profile in ("euroc", "hard"):
        return SlamConfig(max_kf=512, max_mp=16384, n_feat=1024, n_levels=8,
                          local_window=20, use_imu=True, vi_init_time=15.0,
                          g_mag=9.810)
    if profile == "loops":
        # degraded odometry on purpose: a third of the feature budget (full
        # 8-level pyramid kept — the coarse levels are what track through
        # the doubled motion blur), so visual constraints are weaker and
        # the 6x IMU noise accumulates into closable drift across the laps
        return SlamConfig(max_kf=512, max_mp=16384, n_feat=384, n_levels=8,
                          local_window=20, use_imu=True, vi_init_time=15.0,
                          g_mag=9.810)
    if profile == "mid":
        return SlamConfig(max_kf=256, max_mp=8192, n_feat=768, n_levels=4,
                          local_window=12, use_imu=True, vi_init_time=15.0,
                          g_mag=9.810)
    if profile == "small":
        return SlamConfig(max_kf=64, max_mp=4096, n_feat=512, n_levels=3,
                          local_window=8, use_imu=True, vi_init_time=15.0,
                          g_mag=9.810)
    raise ValueError(f"unknown profile {profile!r}")


def default_duration(profile):
    return PROFILE_DURATION.get(profile, 120.0)


def dataset_dir(profile, duration):
    """Fixed in-checkout path of a generated clone."""
    gen = "loops" if profile == "loops" else (
        "hard" if profile == "hard" else "base")
    return os.path.join(DATA_DIR, f"euroc_clone_{gen}_{duration:g}s")


def has_dataset(path):
    return os.path.exists(os.path.join(path, "mav0", "cam0", "data.csv"))


def start_dataset(path, duration, profile):
    """Start generating a clone in a child process that stays on the CPU
    (JAX_PLATFORMS=cpu; the generator also pins the platform itself).
    Returns the Popen, or None when the dataset already exists."""
    if has_dataset(path):
        return None
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable,
           os.path.join(CHECKOUT, "examples", "make_euroc_clone.py"),
           "--out", path, "--duration", str(duration)] \
        + PROFILE_GEN.get(profile, [])
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL)


def finish_dataset(proc, path):
    """Wait for a generator started by `start_dataset`."""
    if proc is not None and proc.wait() != 0:
        raise RuntimeError(f"clone generation failed (rc {proc.returncode})")
    if not has_dataset(path):
        raise RuntimeError(f"no clone dataset at {path}")


def ensure_dataset(path, duration, profile):
    """Generate the clone if missing; returns the seconds it took."""
    t0 = time.perf_counter()
    finish_dataset(start_dataset(path, duration, profile), path)
    return time.perf_counter() - t0


class CompileClock:
    """Counts JAX compiles and their seconds (tracing + backend compile)
    through jax.monitoring, so end-to-end runs can report compile time apart
    from steady time."""

    _EVENTS = ("/jax/core/compile/backend_compile_duration",
               "/jax/core/compile/jaxpr_trace_duration")

    def __init__(self):
        import jax.monitoring
        self.n = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self._EVENTS:
            self.seconds += duration
            if event == self._EVENTS[0]:
                self.n += 1

    def close(self):
        import jax.monitoring
        jax.monitoring.unregister_event_duration_listener(self._on)


def _dataset_hash(mav0):
    """Image csv + imu csv + first/last image bytes: identifies which clone
    instance a run consumed."""
    h = hashlib.sha256()
    for rel in ("cam0/data.csv", "imu0/data.csv"):
        with open(os.path.join(mav0, rel), "rb") as f:
            h.update(f.read())
    img_dir = os.path.join(mav0, "cam0", "data")
    imgs = sorted(os.listdir(img_dir))
    for nm in (imgs[0], imgs[-1]):
        with open(os.path.join(img_dir, nm), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _drift_segments(t_est, P_est, t_gt, P_gt):
    """Aligned error vs time and drift per metre travelled over 5 s windows
    (identifies the dominant error source instead of guessing)."""
    from mc_slam.eval.ate import associate, horn_align
    pairs = associate(t_est, t_gt, 0.02)
    ie = np.asarray([p[0] for p in pairs])
    ig = np.asarray([p[1] for p in pairs])
    Pe, Pg, te = P_est[ie], P_gt[ig], t_est[ie]
    s_al, R_al, t_al = horn_align(Pe, Pg, True)
    Pa = (s_al * (R_al @ Pe.T)).T + t_al
    err_t = np.linalg.norm(Pa - Pg, axis=1)
    seg_len = 5.0
    rows = []
    t0_, tend = te[0], te[-1]
    while t0_ < tend:
        selw = (te >= t0_) & (te < t0_ + seg_len)
        if selw.sum() > 5:
            dist = np.linalg.norm(np.diff(Pg[selw], axis=0), axis=1).sum()
            de = err_t[selw][-1] - err_t[selw][0]
            rows.append({"t0": round(float(t0_ - te[0]), 1),
                         "dist_m": round(float(dist), 2),
                         "err_mean_m": round(float(err_t[selw].mean()), 4),
                         "derr_per_m": round(float(de / max(dist, 1e-6)), 4)})
        t0_ += seg_len
    drift = {"segments": rows,
             "err_t_final_m": round(float(err_t[-1]), 4),
             "worst_segment": max(rows, key=lambda r: r["err_mean_m"])
             if rows else {}}
    return drift, te, err_t


def run_clone(dataset, profile="euroc", max_frames=0, no_loops=False,
              final_gba=False, save_ckpt="", art_dir="", inject_drift=False,
              drift_window=(20.0, 50.0),
              drift_step=(3e-4, -2e-4, 2e-4, 1.5e-4), trace_dir="",
              trace_frames=(0, 0), log=sys.stderr):
    """Run the `profile` pipeline over the clone at `dataset` through
    SlamSystem.track and return the result dict (accuracy, throughput,
    compile telemetry, event log).

    art_dir: where the trajectory, drift and map-snapshot diagnostics go
    (empty = write none). save_ckpt: system checkpoint path (empty = none).
    inject_drift: warp everything created after a cutoff by a small
    per-frame SE3 step during `drift_window` seconds after VI init — the
    loop-closure demonstration (the room world's revisits otherwise re-attach
    within the match window, so closure is never needed).
    trace_dir: write a jax.profiler trace of frames [trace_frames) there
    (the pipeline is drained before the trace stops, so it holds every
    kernel those frames launched)."""
    import jax
    import jax.numpy as jnp
    from mc_slam.camera import euroc_camera
    from mc_slam.eval.ate import ate_rmse
    from mc_slam.io import native_loader
    from mc_slam.pipeline.system import SlamSystem

    mav0 = os.path.join(dataset, "mav0")
    clock = CompileClock()
    t_setup = time.perf_counter()
    slam = SlamSystem(euroc_camera(), profile_config(profile), Tbc=TBC)
    if no_loops:
        slam.enable_loop_closing = False
    loader = native_loader.NativeEurocLoader(mav0)
    setup_s = time.perf_counter() - t_setup

    gt = np.loadtxt(os.path.join(mav0, "state_groundtruth_estimate0",
                                 "data.csv"), delimiter=",", comments="#")
    t_gt = gt[:, 0] / 1e9
    P_gt = gt[:, 1:4]

    times = []
    n = 0

    # device-side drift injection: ONE dispatch per injected frame, no host
    # pulls
    @jax.jit
    def _inject(m, ns_last, Rg, tg, cutoff):
        kf_sel = m.kf_active & (m.kf_id > cutoff)
        ns = m.kf_ns
        P2 = jnp.where(kf_sel[:, None], ns.P @ Rg.T + tg, ns.P)
        R2 = jnp.where(kf_sel[:, None, None],
                       jnp.einsum("ij,kjl->kil", Rg, ns.R), ns.R)
        V2 = jnp.where(kf_sel[:, None], ns.V @ Rg.T, ns.V)
        mp_sel = m.mp_active & (m.mp_first_kf > cutoff)
        X2 = jnp.where(mp_sel[:, None], m.mp_pos @ Rg.T + tg, m.mp_pos)
        N2 = jnp.where(mp_sel[:, None], m.mp_normal @ Rg.T, m.mp_normal)
        m2 = m._replace(kf_ns=ns._replace(P=P2, R=R2, V=V2),
                        mp_pos=X2, mp_normal=N2)
        ns2 = ns_last._replace(P=Rg @ ns_last.P + tg, R=Rg @ ns_last.R,
                               V=Rg @ ns_last.V)
        return m2, ns2

    drift_state = {"cutoff": None, "t_start": None}
    if inject_drift:
        from mc_slam import lie
        dstep = np.asarray(drift_step, np.float32)
        Rg = jnp.asarray(np.asarray(
            lie.so3_exp(jnp.asarray([0.0, 0.0, dstep[3]]))), jnp.float32)
        tg = jnp.asarray(dstep[:3])

    def maybe_inject(t_frame):
        if not inject_drift or not slam.vi_inited or slam.state != 2:
            return
        if drift_state["t_start"] is None:
            drift_state["t_start"] = t_frame
        rel = t_frame - drift_state["t_start"]
        if not (drift_window[0] <= rel <= drift_window[1]):
            return
        if drift_state["cutoff"] is None:
            drift_state["cutoff"] = slam.frame_id - 1
        cut = jnp.asarray(drift_state["cutoff"], jnp.int32)
        slam.m, slam.last_ns = _inject(slam.m, slam.last_ns, Rg, tg, cut)
        slam.last_pose = (slam.last_ns.P, slam.last_ns.R)
        if slam.prior is not None:
            ns0 = slam.prior.ns0
            slam.prior = slam.prior._replace(ns0=ns0._replace(
                P=Rg @ ns0.P + tg, R=Rg @ ns0.R, V=Rg @ ns0.V))

    def run_frame(item):
        nonlocal n
        t_frame, buf, imu_rows = item
        if trace_dir and n == trace_frames[0]:
            jax.profiler.start_trace(trace_dir)
        t0 = time.perf_counter()
        slam.track(buf, t_frame, imu=imu_rows)
        maybe_inject(t_frame)
        times.append(time.perf_counter() - t0)
        n += 1
        if trace_dir and n == trace_frames[1]:
            slam.flush()
            jax.block_until_ready(slam.m.mp_pos)
            jax.profiler.stop_trace()
        if n % 200 == 0:
            stages = " ".join(
                f"{k}={v['median_ms']:.0f}/{v['n']}"
                for k, v in slam.timers.summary().items())
            print(f"frame {n}: state={slam.state} kf={len(slam.kf_slots)} "
                  f"mp={int(slam.m.mp_active.sum())} vi={slam.vi_inited} "
                  f"loops={slam.n_loops_closed} "
                  f"median={np.median(times)*1e3:.0f}ms [{stages}]",
                  file=log)

    # one-frame lookahead: the NEXT frame's (uint8) host->device upload is
    # issued before tracking the current frame so the transfer overlaps compute
    compile_s0, n_comp0 = clock.seconds, clock.n
    pending = None
    for t_frame, img, imu_rows in loader:
        buf = slam.upload(img)
        if pending is not None:
            run_frame(pending)
            if max_frames and n >= max_frames:
                pending = None
                break
        pending = (t_frame, buf, imu_rows)
    if pending is not None:
        run_frame(pending)
    loader.close()
    t0 = time.perf_counter()
    slam.flush()
    flush_s = time.perf_counter() - t0
    compile_s = clock.seconds - compile_s0
    n_backend_compiles = clock.n - n_comp0

    if final_gba:
        t0 = time.perf_counter()
        slam.global_refine()
        print(f"final GBA: {time.perf_counter() - t0:.1f}s", file=log)
    if save_ckpt:
        from mc_slam.io import checkpoint
        os.makedirs(os.path.dirname(os.path.abspath(save_ckpt)),
                    exist_ok=True)
        checkpoint.save_system(save_ckpt, slam)
        print(f"checkpoint -> {save_ckpt}", file=log)
    clock.close()
    traj = slam.get_trajectory()
    t_est = np.asarray([x[0] for x in traj])
    P_est = np.asarray([x[1] for x in traj])
    # score both with Sim3 alignment (the reference's mono scoring always
    # aligns scale) and on the post-VI-init stretch only
    stats_s = ate_rmse(t_est, P_est, t_gt, P_gt, with_scale=True)
    post = t_est > t_est[0] + 20.0
    stats_post = (ate_rmse(t_est[post], P_est[post], t_gt, P_gt,
                           with_scale=True) if post.sum() > 10 else {})
    if "scale" not in stats_s:
        raise RuntimeError(f"only {stats_s['n']} tracked frames to score")
    drift, te, err_t = _drift_segments(t_est, P_est, t_gt, P_gt)
    if art_dir:
        os.makedirs(art_dir, exist_ok=True)
        np.savez(os.path.join(art_dir, f"drift_clone_{profile}.npz"),
                 te=te, err_t=err_t)
        # anchor diagnostics: which keyframe each frame composed through, and
        # whether it fell back to its stale track-time pose (culled/recycled)
        kf_id_h = np.asarray(slam.m.kf_id)
        kf_act_h = np.asarray(slam.m.kf_active)
        anchor_kid = np.asarray([
            (kd if (k >= 0 and kf_act_h[k] and kf_id_h[k] == kd) else -1)
            for (_, k, kd) in slam.traj.meta], np.int64)
        np.savez(os.path.join(art_dir, f"traj_clone_{profile}.npz"),
                 t_est=t_est, P_est=P_est, t_gt=t_gt, P_gt=P_gt,
                 anchor_kid=anchor_kid)
        try:
            from mc_slam.viz import save_map_snapshot
            save_map_snapshot(
                slam.m, traj,
                os.path.join(art_dir, f"map_clone_{profile}.png"),
                title=f"clone/{profile}: {n} frames, "
                      f"{len(slam.kf_slots)} KFs, {slam.n_loops_closed} loops")
        except ImportError as e:      # matplotlib is optional
            print(f"map snapshot skipped: {e}", file=log)
    # wall-clock attribution (the reference prints median AND mean,
    # mono_EuRoC_vins.cc:188-232); the remainder is compiles and host glue
    stages = slam.timers.summary()
    wall = float(sum(times)) + flush_s
    attributed = sum(v["total_s"] for v in stages.values())
    from mc_slam.pipeline import tracking
    # recompile telemetry: steady state must not recompile per frame
    ncomp = {
        "frame_vi": int(tracking.frame_pipeline_vi._cache_size()),
        "frame_vi_pair": int(tracking.frame_pipeline_vi_pair._cache_size()),
        "frame_visual": int(tracking.frame_pipeline_visual._cache_size()),
        "backend_compiles": n_backend_compiles,
    }
    # longest lost->relocalized span (the hard-profile robustness metric:
    # "not lost, or relocalizes within N frames")
    lost_ev = [f for f, k, _ in slam.events if k == "lost"]
    reloc_ev = [f for f, k, _ in slam.events if k == "reloc"]
    streaks = [min([r for r in reloc_ev if r >= f], default=n) - f
               for f in lost_ev]
    dev = jax.devices()[0]
    try:
        peak = int(dev.memory_stats()["peak_bytes_in_use"])
    except (TypeError, KeyError):      # the CPU backend keeps no stats
        peak = -1
    return {
        "frames": n,
        "n_lost": int(slam.n_lost_frames),
        "n_relocs": len(reloc_ev),
        "max_lost_streak": int(max(streaks, default=0)),
        "tracking_finished_ok": bool(slam.state == 2),
        "keyframes": len(slam.kf_slots),
        "map_points": int(slam.m.mp_active.sum()),
        "vi_inited": bool(slam.vi_inited),
        "loops_closed": int(slam.n_loops_closed),
        "median_track_ms": float(np.median(times) * 1e3),
        "mean_track_ms": float(np.mean(times) * 1e3),
        # amortized end-to-end throughput: total frames / total processing
        # wall clock INCLUDING keyframe-rate events (local mapping, loop
        # closing, GBA) and first-compile warmup — the honest pipeline rate
        "e2e_fps_amortized": float(n / max(wall, 1e-9)),
        # steady-state fps excluding the first 100 frames (compile warmup)
        "e2e_fps_warm": float((n - 100) / max(sum(times[100:]), 1e-9))
        if n > 200 else -1.0,
        "setup_s": setup_s,
        "compile_s": compile_s,
        "steady_s": wall - compile_s,
        "wall_s": wall,
        "wall_attributed_s": round(attributed, 1),
        "wall_unattributed_s": round(wall - attributed, 1),
        "abs_scale_err": abs(1.0 - float(stats_s["scale"])),
        "ate_rmse": float(stats_s["rmse"]),
        "ate_scale": float(stats_s["scale"]),
        "ate_rmse_post_init": float(stats_post.get("rmse", -1.0)),
        "ate_scale_post_init": float(stats_post.get("scale", -1.0)),
        "profile": profile,
        "dataset": os.path.abspath(dataset),
        "dataset_hash": _dataset_hash(mav0),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "peak_bytes_in_use": peak,
        "drift_injected": bool(inject_drift),
        "drift_params": ({"window_s": list(drift_window),
                          "step": list(drift_step),
                          "cutoff_fid": drift_state["cutoff"]}
                         if inject_drift else None),
        "loop_closing_enabled": not no_loops,
        "n_compiles": ncomp,
        "stage_ms": {k: round(v["median_ms"], 2) for k, v in stages.items()},
        "drift": drift,
        "events": [[int(f), k, d] for f, k, d in slam.events][-400:],
        "stage_detail": {k: {"n": v["n"],
                             "median_ms": round(v["median_ms"], 2),
                             "mean_ms": round(v["mean_ms"], 2),
                             "max_ms": round(v["max_ms"], 1),
                             "total_s": round(v["total_s"], 1)}
                         for k, v in stages.items()},
    }


def gate_failures(result, gate_ate=0.15, gate_scale=0.02, gate_lost=60,
                  gate_fps=None):
    """The acceptance gates (reference: run.sh + evaluate_ate.py
    per-sequence bounds). Returns the list of failures; gate_fps None skips
    the throughput gate."""
    fails = []
    profile = result["profile"]
    if profile == "hard":
        # survival gate (V1_03 analog, config/euroc.yaml:18-20): never
        # permanently lost — every loss must relocalize within 5 s
        if result["max_lost_streak"] > 100:
            fails.append(f"max_lost_streak {result['max_lost_streak']}"
                         f" > 100 frames")
        if not result["tracking_finished_ok"]:
            fails.append("tracking did not finish in OK state")
    else:
        if result["ate_rmse_post_init"] > gate_ate:
            fails.append(f"ate_rmse_post_init "
                         f"{result['ate_rmse_post_init']:.3f} > {gate_ate}")
        if result["abs_scale_err"] > gate_scale:
            fails.append(f"abs_scale_err {result['abs_scale_err']:.4f}"
                         f" > {gate_scale}")
        if result["n_lost"] > gate_lost:
            fails.append(f"n_lost {result['n_lost']} > {gate_lost}")
    if (profile == "loops" and result["loop_closing_enabled"]
            and result["loops_closed"] < 1):
        fails.append("loops_closed 0 on the multi-lap drift profile")
    if gate_fps is not None and result["e2e_fps_amortized"] < gate_fps:
        fails.append(f"e2e_fps {result['e2e_fps_amortized']:.1f}"
                     f" < {gate_fps}")
    return fails
