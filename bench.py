"""Benchmark on one NVIDIA GPU. Prints ONE JSON line last:
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...},
 "sub": {...}}

Headline: the amortized end-to-end pipeline rate — the full SlamSystem
(tracking, local mapping, loop closing, VI init) over the euroc-profile
clone, run in this process through mc_slam.eval.clone.run_clone, every
keyframe-rate stall and compile included. vs_baseline = fps / 20, the
camera rate the reference runs in real time at (BASELINE.md).

Sub-metrics: fused frame tracking, extraction, the local VI window BA (XYZ
and IDP forms), batched 8-sequence tracking, the Hamming GEMM and the
map-scale chunked GBA, with achieved rates against the card's data-sheet
peaks (PEAKS, keyed by device_kind; an unknown card is an error).

    python bench.py [--e2e-seconds 30] [--trace DIR]

Requires a GPU; any failed phase exits non-zero.
"""
import argparse
import json
import sys
import time

import numpy as np

# Data-sheet peaks (NVIDIA H100 SXM5 data sheet, dense, no sparsity; the
# rates assume the card's 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
        "int8_ops": 1979e12, "hbm_bytes_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense"},
}


def peaks_for(device_kind):
    if device_kind not in PEAKS:
        raise KeyError(f"no data-sheet peaks for {device_kind!r}: add them "
                       f"to bench.PEAKS with their source")
    return PEAKS[device_kind]


def timeit(f, n=20, warmup=2):
    import jax
    for _ in range(warmup):
        jax.block_until_ready(f())
    t0 = time.perf_counter()
    for _ in range(n):
        out = f()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def xla_cost(jitted, *args):
    """XLA's flop and byte estimate for the compiled executable."""
    ca = jitted.lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def microbenches(sub):
    import jax
    import jax.numpy as jnp

    from mc_slam.bench_problems import (gba_map_problem,
                                            vi_window_idp_problem,
                                            vi_window_problem)
    from mc_slam.camera import euroc_camera
    from mc_slam.frontend import extractor, matching
    from mc_slam.frontend.orb import unpack_pm1
    from mc_slam.parallel import multiseq
    from mc_slam.pipeline import tracking
    from mc_slam.slam_map.mapstate import empty_map
    from mc_slam.solver import ba_chunked, ba_vi, ba_vi_idp, factors

    rng = np.random.default_rng(0)
    cam = euroc_camera()
    ext = factors.identity_extrinsics()

    # --- full frame tracking (extract + match-vs-map + pose LM) ---
    H, W = 480, 752
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    NF, NL = 1024, 8
    P_mp = 16384
    m = empty_map(max_kf=4, max_mp=P_mp, n_feat=NF)
    pts = np.stack([rng.uniform(-6, 6, P_mp), rng.uniform(-4, 4, P_mp),
                    rng.uniform(3, 12, P_mp)], 1).astype(np.float32)
    words = rng.integers(0, 2**32, size=(P_mp, 8), dtype=np.uint32)
    pm1 = unpack_pm1(jnp.asarray(words))
    m = m._replace(mp_pos=jnp.asarray(pts), mp_pm1=pm1,
                   mp_active=jnp.ones(P_mp, bool),
                   mp_min_dist=jnp.full(P_mp, 0.5),
                   mp_max_dist=jnp.full(P_mp, 30.0))
    P0, R0 = jnp.zeros(3), jnp.eye(3)

    @jax.jit
    def frame_step(img, m, P0, R0):
        # the map is an argument: a closed-over map would be baked into the
        # executable as a 16k-point constant
        f = extractor.extract(img, n_features=NF, n_levels=NL)
        res = tracking.track_frame_visual(m, f, f.xy, cam, ext, P0, R0,
                                          iters=10)
        return res.P, res.n_inliers

    dt_frame = timeit(lambda: frame_step(img, m, P0, R0), n=20)
    sub["frame_tracking_ms"] = dt_frame * 1e3
    print(f"# frame_tracking: {dt_frame*1e3:.3f} ms", file=sys.stderr)

    ex = jax.jit(lambda im: extractor.extract(im, n_features=NF,
                                              n_levels=NL).xy)
    dt_ex = timeit(lambda: ex(img), n=20)
    sub["extraction_ms"] = dt_ex * 1e3
    print(f"# extraction: {dt_ex*1e3:.3f} ms", file=sys.stderr)

    # --- local-window VI BA (20 KFs, 2k points, 10k obs), XYZ and IDP ---
    p = vi_window_problem(n_kf=20, n_pts=2048, obs_per_kf=512)
    dt_ba = timeit(lambda: ba_vi.vi_ba(
        p["ns"], p["pts"], p["obs"], p["edges"], p["cam"], p["ext"],
        p["gw"], p["free"], p["pt_mask"], iters=10)[3], n=5)
    sub["vi_ba_20kf_ms"] = dt_ba * 1e3
    print(f"# local VI BA (10 LM iters): {dt_ba*1e3:.3f} ms", file=sys.stderr)

    pi = vi_window_idp_problem(n_kf=20, n_pts=2048, obs_per_kf=512)

    def idp_step():
        return ba_vi_idp.vi_ba_idp(
            pi["ns"], pi["rho"], pi["idp_obs"], pi["edges"], pi["cam"],
            pi["ext"], pi["gw"], pi["free"], pi["rho_mask"], iters=10)[3]

    dt_idp = timeit(idp_step, n=5)
    sub["vi_ba_idp_20kf_ms"] = dt_idp * 1e3
    print(f"# IDP window BA (10 LM iters): {dt_idp*1e3:.3f} ms",
          file=sys.stderr)

    # --- batched multi-sequence tracking (8 sequences, 1 card) ---
    B = 8
    ms = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), m)
    imgs_b = jnp.broadcast_to(img[None], (B, H, W))
    P0b = jnp.zeros((B, 3))
    R0b = jnp.broadcast_to(jnp.eye(3), (B, 3, 3))
    mstep = multiseq.make_batched_step(cam, ext, n_features=NF, n_levels=NL)
    dt_ms = timeit(lambda: mstep(ms, imgs_b, P0b, R0b)[0], n=10)
    sub["batched8_fps_aggregate"] = B / dt_ms
    print(f"# batched 8-seq tracking: {dt_ms*1e3:.3f} ms", file=sys.stderr)

    # --- Hamming GEMM 1024 x 16384 (the full matrix: a reduction of it
    # would let XLA rewrite sum(dot) into a dot of sums) ---
    a = pm1[:1024]
    hm = jax.jit(matching.hamming_matrix)
    dt_hm = timeit(lambda: hm(a, pm1), n=20)
    sub["hamming_gpairs_s"] = 1024 * P_mp / dt_hm / 1e9
    print(f"# hamming 1024x16384: {dt_hm*1e3:.4f} ms", file=sys.stderr)

    # --- map-scale chunked VI GBA (128 KF / 12k pts / ~50k obs) ---
    (ns, gp, cobs, edges, gcam, gext, gw, free, ptm,
     meta) = gba_map_problem()
    iters = 8
    dt_gba = timeit(lambda: ba_chunked.vi_gba_chunked(
        ns, gp, cobs, edges, gcam, gext, gw, free, ptm, iters=iters)[2],
        n=3, warmup=1) / iters
    sub["gba_map_iter_ms"] = dt_gba * 1e3
    sub["gba_map_problem"] = meta
    print(f"# chunked GBA per LM iter: {dt_gba*1e3:.3f} ms", file=sys.stderr)

    # --- achieved rates against the data-sheet peaks ---
    pk = peaks_for(jax.devices()[0].device_kind)
    hm_ops = 2.0 * 1024 * P_mp * 256
    idp_flops, _ = xla_cost(jax.jit(idp_step))
    _, ex_bytes = xla_cost(ex, img)
    sub["roofline"] = {
        "peaks_source": pk["source"],
        "hamming_pct_int8_peak": 100 * hm_ops / dt_hm / pk["int8_ops"],
        "idp_ba_pct_f32_peak": 100 * idp_flops / dt_idp / pk["f32_flops"],
        "extraction_pct_hbm_peak":
            100 * ex_bytes / dt_ex / pk["hbm_bytes_s"],
    }
    print(f"# roofline: {sub['roofline']}", file=sys.stderr)


def search_ms(M=16384, N=1024):
    """search_by_projection alone at the euroc profile's widths (ms/call)."""
    import jax
    import jax.numpy as jnp
    from mc_slam.frontend import matching
    from mc_slam import testing
    from mc_slam.frontend.orb import unpack_pm1
    p = testing.projection_problem(np.random.default_rng(2), M, N)
    f = jax.jit(lambda *a: matching.search_by_projection(*a, radius_px=15.0))
    args = [jnp.asarray(p[k]) for k in ("proj_uv", "proj_valid",
                                        "proj_level")]
    args += [unpack_pm1(jnp.asarray(p["proj_desc"])),
             jnp.asarray(p["feat_uv"]), jnp.asarray(p["feat_level"]),
             unpack_pm1(jnp.asarray(p["feat_desc"])),
             jnp.asarray(p["feat_valid"])]
    return timeit(lambda: f(*args), n=50) * 1e3


def trace_summary(trace_dir, n_frames):
    """Device-time breakdown of the traced frames: the steady frame program
    (frame_pipeline_vi_pair) and the projection search inside it, from the
    trace and from the search's own time (two searches per frame)."""
    from mc_slam.utils import trace
    ev = trace.device_events(trace.newest_xplane(trace_dir))
    all_ = trace.summarize(ev, scopes=("search_by_projection",))
    frame = trace.summarize(ev, scopes=("search_by_projection",),
                            module_filter="frame_pipeline_vi")
    s_ms = search_ms()
    return {"frames": n_frames,
            "frame_program_ms_per_frame": frame["kernel_ns"] / 1e6 / n_frames,
            "search_ms_per_call_alone": s_ms,
            "search_share_estimate": 2 * s_ms * n_frames
                / max(frame["kernel_ns"] / 1e6, 1e-9),
            "window_ms": all_["window_ns"] / 1e6,
            "busy_ms": all_["busy_ns"] / 1e6,
            "idle_share": 1 - all_["busy_ns"] / max(all_["window_ns"], 1),
            "by_module_ms": {k: v / 1e6
                             for k, v in list(all_["by_module"].items())[:15]},
            "frame_program_ms": frame["kernel_ns"] / 1e6,
            "search_by_projection_ms":
                frame["by_scope"]["search_by_projection"] / 1e6,
            "search_share_of_frame_program":
                frame["by_scope"]["search_by_projection"]
                / max(frame["kernel_ns"], 1),
            "frame_top_kernels_ms": {k: v / 1e6 for k, v in
                                     list(frame["by_kernel"].items())[:25]},
            "frame_top_ops_ms": {k: v / 1e6 for k, v in
                                 list(frame["by_op"].items())[:40]},
            "frame_by_stage_ms": {k: v / 1e6 for k, v in trace.summarize(
                ev, module_filter="frame_pipeline_vi",
                depth=3)["by_op"].items()}}


def main():
    ap = argparse.ArgumentParser(description="GPU benchmark")
    ap.add_argument("--e2e-seconds", type=float, default=30.0,
                    help="clone length for the end-to-end run (0 skips it)")
    ap.add_argument("--trace", default="",
                    help="trace frames 440-480 of the end-to-end run into "
                         "this directory and print the device-time breakdown")
    args = ap.parse_args()

    import jax
    from mc_slam import runtime
    dev = runtime.use_gpu()
    runtime.setup_compile_cache()
    peaks_for(dev.device_kind)
    print(f"# device: {runtime.device_info(jax.devices())}", file=sys.stderr)

    sub = {}
    microbenches(sub)

    head = None
    if args.e2e_seconds:
        from mc_slam.eval import clone
        ds = clone.dataset_dir("euroc", args.e2e_seconds)
        sub["e2e_setup_generate_s"] = clone.ensure_dataset(
            ds, args.e2e_seconds, "euroc")
        window = (440, 480)
        e2e = clone.run_clone(ds, "euroc", trace_dir=args.trace,
                              trace_frames=window)
        keep = ("frames", "keyframes", "map_points", "vi_inited", "n_lost",
                "loops_closed", "ate_rmse", "ate_rmse_post_init",
                "abs_scale_err", "e2e_fps_amortized", "e2e_fps_warm",
                "median_track_ms", "setup_s", "compile_s", "steady_s",
                "wall_s", "n_compiles", "peak_bytes_in_use", "stage_ms",
                "dataset_hash")
        sub["e2e"] = {k: e2e[k] for k in keep}
        fails = clone.gate_failures(e2e)
        if fails:
            raise SystemExit("e2e gates failed: " + "; ".join(fails))
        head = e2e["e2e_fps_amortized"]
        if args.trace:
            sub["trace"] = trace_summary(args.trace, window[1] - window[0])
            print(f"# trace: {json.dumps(sub['trace'])}", file=sys.stderr)

    out = {"device": runtime.device_info(jax.devices()), "sub": sub}
    if head is not None:
        out.update(metric="e2e_pipeline_fps", value=head,
                   unit="frames/s amortized, full pipeline (euroc clone)",
                   vs_baseline=head / 20.0)
    else:
        fps = 1e3 / sub["frame_tracking_ms"]
        out.update(metric="frame_tracking_fps", value=fps,
                   unit="frames/s (752x480, 1024 feat, 16k-pt map)",
                   vs_baseline=fps / 20.0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
