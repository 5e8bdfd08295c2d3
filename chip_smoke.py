#!/usr/bin/env python
"""Smoke run of the full VI-SLAM pipeline on one NVIDIA GPU.

    python chip_smoke.py            # phases 0-2 on one card
    python chip_smoke.py --four     # phase 3 only: the mesh path on 4 cards
    python chip_smoke.py --tiny     # CPU rehearsal at small sizes

Phase 0 pins JAX to the GPU (no CPU fallback), names the card and places the
compile cache. Phase 1 compares the matcher, the ORB extractor and the IDP
window BA on the card with their plain references at real widths. Phase 2
generates a 30 s EuRoC clone in a CPU-only child process and runs the
`euroc` profile (752x480, 1024 ORB features over 8 levels, 20-KF VI window,
512 KF / 16,384 map-point slots) through SlamSystem.track, the path
examples/eval_clone.py drives, and holds it to eval_clone's accuracy gates.
Phase 3 (--four) runs the landmark-sharded whole-map GBA, the edge-sharded
pose graph and the pipeline's mesh wiring on four cards against one.

Stops at the first failure with a non-zero exit. The last line printed is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

CLONE_SECONDS = 30.0


def card_name_and_power():
    """`nvidia-smi` name and power limit, read in a child that stays off
    JAX."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def log(msg):
    print(msg, flush=True)


def timed(f, n=5):
    """Mean seconds per call of f() after one warm call (device time plus
    dispatch; every call ends in block_until_ready)."""
    import jax
    jax.block_until_ready(f())
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(f())
    return (time.perf_counter() - t0) / n


def on(dev, tree):
    """Commit the array leaves of `tree` to `dev`."""
    import jax
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, dev) if isinstance(x, jax.Array) else x,
        tree)


# ---------------------------------------------------------------------------
# phase 1: kernels and solvers at real widths against the plain references
# ---------------------------------------------------------------------------

def check_hamming(dev, tag, na, nb):
    import jax
    from mc_slam.frontend import matching
    from mc_slam import testing
    from mc_slam.frontend.orb import unpack_pm1
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, (na, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (nb, 8), dtype=np.uint32)
    pa = unpack_pm1(jax.device_put(a, dev))
    pb = unpack_pm1(jax.device_put(b, dev))
    f = jax.jit(matching.hamming_matrix)
    got = np.asarray(f(pa, pb))
    ref = testing.hamming_popcount(a, b)
    if not np.array_equal(got, ref):
        raise AssertionError(f"hamming_matrix differs from popcount in "
                             f"{int((got != ref).sum())} entries")
    dt = timed(lambda: f(pa, pb))
    log(f"{tag} phase1 hamming_matrix {na}x{nb}: bit-exact vs NumPy popcount "
        f"(tolerance 0, int8 GEMM with int32 accumulation); "
        f"{dt * 1e3:.3f} ms/call, {na * nb / dt / 1e9:.1f} Gpairs/s")


def check_projection_search(dev, tag, M, N):
    import jax
    from mc_slam.frontend import matching
    from mc_slam import testing
    from mc_slam.frontend.orb import unpack_pm1
    p = testing.projection_problem(np.random.default_rng(2), M, N)
    radius = 15.0      # tracking's coarse round (track_frame_vi)
    for ratio in (0.9, None):
        for with_angles in (True, False):
            akw = (dict(proj_angle=p["proj_angle"], feat_angle=p["feat_angle"],
                        proj_angle_valid=p["proj_angle_valid"])
                   if with_angles else {})
            ref = testing.search_by_projection(
                p["proj_uv"], p["proj_valid"], p["proj_level"], p["proj_desc"],
                p["feat_uv"], p["feat_level"], p["feat_desc"], p["feat_valid"],
                radius, ratio=ratio, **akw)
            f = jax.jit(lambda *a, **k: matching.search_by_projection(
                *a, radius_px=radius, ratio=ratio, **k))
            args = [jax.device_put(p[k], dev) for k in
                    ("proj_uv", "proj_valid", "proj_level")]
            args += [unpack_pm1(jax.device_put(p["proj_desc"], dev))]
            args += [jax.device_put(p[k], dev) for k in
                     ("feat_uv", "feat_level")]
            args += [unpack_pm1(jax.device_put(p["feat_desc"], dev)),
                     jax.device_put(p["feat_valid"], dev)]
            kw = {k: jax.device_put(v, dev) for k, v in akw.items()}
            got = [np.asarray(x) for x in f(*args, **kw)]
            for name, g, r in zip(("idx", "dist", "ok"), got, ref):
                if not np.array_equal(g, r):
                    raise AssertionError(
                        f"search_by_projection {name} differs "
                        f"(ratio={ratio}, angles={with_angles}) in "
                        f"{int((g != r).sum())} entries")
            dt = timed(lambda: f(*args, **kw))
            log(f"{tag} phase1 search_by_projection M={M} N={N} r={radius} "
                f"ratio={ratio} angles={with_angles}: (idx, dist, ok) exact "
                f"vs NumPy brute force ({int(ref[2].sum())} matches); "
                f"{dt * 1e3:.3f} ms/call")


def clone_frame(width=752, height=480, seed=3):
    """One rendered EuRoC-geometry frame of the clone world (uint8)."""
    from mc_slam.camera import euroc_camera
    from mc_slam.eval.clone import TBC
    from mc_slam.sim import MavTrajectory, RoomWorld
    world = RoomWorld(np.random.default_rng(seed), tex_size=1024)
    P, R = MavTrajectory(duration=30.0).pose(4.0)
    Rbc, pbc = TBC[:3, :3].astype(np.float64), TBC[:3, 3]
    img = world.render(euroc_camera(), R @ Rbc, P + R @ pbc)
    assert img.shape == (height, width), img.shape
    return np.clip(img, 0, 255).astype(np.uint8)


def check_extract(dev, cpu, tag, n_features, n_levels):
    """Extraction on the card vs the CPU backend. Tolerance: the same
    keypoint count, >= 98% of card keypoints within 1 px of a CPU keypoint
    on the same level, median descriptor Hamming 0 on those — FAST scores
    and the orientation moments are float sums whose order differs between
    backends, so a few near-tie keypoints may swap for a neighbour."""
    import jax
    from mc_slam.frontend import extractor
    from mc_slam import testing
    img = clone_frame()
    out = {}
    for name, d in (("gpu", dev), ("cpu", cpu)):
        f = extractor.extract(jax.device_put(img, d), n_features=n_features,
                              n_levels=n_levels)
        out[name] = {k: np.asarray(getattr(f, k))
                     for k in ("xy", "level", "desc", "valid")}
    g, c = out["gpu"], out["cpu"]
    ng, nc = int(g["valid"].sum()), int(c["valid"].sum())
    if ng != nc or ng == 0:
        raise AssertionError(f"extract: {ng} keypoints on the card, {nc} on "
                             f"the CPU")
    gi, ci = np.nonzero(g["valid"])[0], np.nonzero(c["valid"])[0]
    d2 = ((g["xy"][gi, None, :] - c["xy"][None, ci, :]) ** 2).sum(-1)
    d2 = np.where(g["level"][gi, None] == c["level"][None, ci], d2, np.inf)
    nn = np.argmin(d2, axis=1)
    close = d2[np.arange(len(gi)), nn] <= 1.0
    share = float(close.mean())
    ham = np.asarray([testing.hamming_popcount(
        g["desc"][gi[i]][None], c["desc"][ci[nn[i]]][None])[0, 0]
        for i in np.nonzero(close)[0]])
    med = float(np.median(ham)) if ham.size else float("inf")
    if share < 0.98 or med != 0:
        raise AssertionError(f"extract: {share:.4f} of keypoints within 1 px "
                             f"(need 0.98), median Hamming {med} (need 0)")
    fj = lambda: extractor.extract(jax.device_put(img, dev),  # noqa: E731
                                   n_features=n_features, n_levels=n_levels)
    dt = timed(lambda: fj().xy)
    log(f"{tag} phase1 extract 752x480 {n_features} features {n_levels} "
        f"levels: {ng} keypoints on both; {share:.4f} within 1 px on the same "
        f"level (need >= 0.98); median descriptor Hamming {med:g} (need 0); "
        f"{dev.platform} {dt * 1e3:.3f} ms/frame")


def check_idp_ba(dev, cpu, tag, n_kf, n_pts, obs_per_kf, iters=10):
    """IDP window BA on the card vs the CPU backend, both at
    jax_default_matmul_precision="highest" (no TF32 on the card). Tolerance:
    final cost within 1e-3 relative; positions within 1 mm and rotations
    within 1e-4 of each other — f32 sums in another order, 10 LM steps."""
    import jax
    from mc_slam.bench_problems import vi_window_idp_problem
    from mc_slam.solver import ba_vi_idp
    with jax.default_device(cpu):
        p = vi_window_idp_problem(n_kf=n_kf, n_pts=n_pts,
                                  obs_per_kf=obs_per_kf)
    keys = ("ns", "rho", "idp_obs", "edges", "cam", "ext", "gw", "free",
            "rho_mask")
    res = {}
    for name, d in (("gpu", dev), ("cpu", cpu)):
        args = on(d, tuple(p[k] for k in keys))
        ns, rho, chi2, cost = ba_vi_idp.vi_ba_idp(*args, iters=iters)
        res[name] = (np.asarray(ns.P), np.asarray(ns.R), float(cost))
        if name == "gpu":
            dt = timed(lambda: ba_vi_idp.vi_ba_idp(*args, iters=iters)[3])
    (Pg, Rg, cg), (Pc, Rc, cc) = res["gpu"], res["cpu"]
    rel = abs(cg - cc) / max(abs(cc), 1e-12)
    dP = float(np.abs(Pg - Pc).max())
    dR = float(np.abs(Rg - Rc).max())
    if not (np.isfinite(cg) and rel <= 1e-3 and dP <= 1e-3 and dR <= 1e-4):
        raise AssertionError(f"vi_ba_idp: cost {cg} vs {cc} (rel {rel:.2e}), "
                             f"max |dP| {dP:.2e}, max |dR| {dR:.2e}")
    log(f"{tag} phase1 vi_ba_idp {n_kf} KF / {n_pts} pts / "
        f"{n_kf * obs_per_kf} obs, {iters} LM iters, precision=highest "
        f"(f32, no TF32): cost {cg:.6g} vs CPU {cc:.6g} (rel {rel:.2e}, "
        f"need <= 1e-3); max |dP| {dP:.2e} m (<= 1e-3), max |dR| {dR:.2e} "
        f"(<= 1e-4); {dev.platform} {dt * 1e3:.3f} ms/solve")


# ---------------------------------------------------------------------------
# phase 2: the main path at full width
# ---------------------------------------------------------------------------

def run_pipeline(tag, profile, dataset, gen, tiny):
    from mc_slam.eval import clone
    from mc_slam.io import native_loader
    t0 = time.perf_counter()
    clone.finish_dataset(gen, dataset)
    gen_wait = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_loader.build()
    build_s = time.perf_counter() - t0
    log(f"{tag} phase2 set-up: clone at {dataset} (waited {gen_wait:.1f} s "
        f"after phase 1), native loader build {build_s:.1f} s")
    r = clone.run_clone(dataset, profile, max_frames=120 if tiny else 0,
                        log=sys.stdout)
    peak = r["peak_bytes_in_use"]
    log(f"{tag} phase2 {profile}: frames {r['frames']}, keyframes "
        f"{r['keyframes']}, map points {r['map_points']}")
    log(f"{tag} phase2 vi_inited {r['vi_inited']}, n_lost {r['n_lost']}, "
        f"loops_closed {r['loops_closed']}, tracking_finished_ok "
        f"{r['tracking_finished_ok']}")
    log(f"{tag} phase2 ATE post-init {r['ate_rmse_post_init']:.5f} m, "
        f"ATE {r['ate_rmse']:.5f} m, abs_scale_err {r['abs_scale_err']:.5f}")
    log(f"{tag} phase2 set-up {r['setup_s']:.2f} s, compile "
        f"{r['compile_s']:.2f} s ({r['n_compiles']['backend_compiles']} "
        f"backend compiles), steady {r['steady_s']:.2f} s of {r['wall_s']:.2f}"
        f" s wall")
    log(f"{tag} phase2 fps amortized {r['e2e_fps_amortized']:.3f}, warm "
        f"{r['e2e_fps_warm']:.3f}, median frame {r['median_track_ms']:.3f} ms")
    log(f"{tag} phase2 n_compiles {json.dumps(r['n_compiles'])}, "
        f"peak_bytes_in_use {peak} ({peak / 2**30:.3f} GiB)")
    log(f"{tag} phase2 stage_ms {json.dumps(r['stage_ms'])}")
    fails = clone.gate_failures(r, gate_ate=0.15, gate_scale=0.02,
                                gate_lost=60)
    if not r["tracking_finished_ok"]:
        fails.append("tracking did not finish in OK state")
    if not r["vi_inited"]:
        fails.append("VI init never succeeded")
    if r["ate_rmse_post_init"] < 0:
        fails.append("no post-init stretch to score")
    if fails:
        if tiny:
            log(f"{tag} phase2 gates (not enforced at --tiny): {fails}")
        else:
            raise AssertionError("phase2 gates: " + "; ".join(fails))
    else:
        log(f"{tag} phase2 gates passed: ATE post-init <= 0.15 m, "
            f"abs_scale_err <= 0.02, n_lost <= 60, tracking ok, VI init")


# ---------------------------------------------------------------------------
# phase 3 (--four): the mesh path on four cards against one
# ---------------------------------------------------------------------------

def _peaks(devs):
    out = []
    for d in devs:
        try:
            out.append(int(d.memory_stats()["peak_bytes_in_use"]))
        except (TypeError, KeyError):
            out.append(-1)
    return out


def four_cards(tag, n, tiny):
    import jax
    import jax.numpy as jnp
    from mc_slam.bench_problems import gba_map_problem
    from mc_slam.parallel import dist_ba, dist_gba
    from mc_slam.solver import ba_chunked
    from mc_slam import testing

    devs = jax.devices()
    if len(devs) < n:
        raise RuntimeError(f"--four needs {n} devices, JAX sees {len(devs)}")
    mesh = dist_ba.make_mesh(n)

    # (a) landmark-sharded whole-map VI GBA vs the single-device solver
    sizes = (dict(n_kf=16, n_pts=1024, obs_per_kf=128, n_chunks=16) if tiny
             else dict(n_kf=128, n_pts=12288, obs_per_kf=400, n_chunks=96))
    (ns, pts, cobs, edges, cam, ext, gw, free, ptm,
     meta) = gba_map_problem(**sizes)
    cobs_s = dist_gba.shard_chunked_obs(mesh, cobs)

    def single(iters):
        return ba_chunked.vi_gba_chunked(
            ns, pts, cobs, edges, cam, ext, gw, free, ptm, iters=iters)

    def sharded(iters):
        return dist_gba.vi_gba_chunked_sharded(
            mesh, ns, pts, cobs_s, edges, cam, ext, gw, free, ptm,
            iters=iters)

    # One LM step is compared: the synthetic problem's random IMU rows
    # disagree with its poses (cost ~1.6e7), so after a few steps the f32
    # reduction order steers LM's accept/reject decisions apart; one step
    # holds the sharded Schur reduction, psum, solve and back-substitution
    # to the single-device algebra.
    ns1, pts1, c1 = single(1)
    nsn, ptsn, cn = sharded(1)
    span = len(ptsn.sharding.device_set)
    dP = float(jnp.abs(nsn.P - ns1.P).max())
    dX = float(jnp.abs(ptsn - pts1).max())
    rel = abs(float(cn) - float(c1)) / max(abs(float(c1)), 1e-12)
    log(f"{tag} phase3 GBA {meta['n_kf']} KF / {meta['n_pts']} pts / "
        f"{meta['n_obs']} obs, one LM step: cost 1 dev {float(c1):.7g}, {n} "
        f"dev {float(cn):.7g} (rel {rel:.2e}, need <= 1e-4); max |dP| "
        f"{dP:.2e} m (<= 1e-3), max |dX| {dX:.2e} m (<= 2e-2); observations "
        f"sharded over {len(cobs_s.cam.sharding.device_set)} devices, "
        f"result on {span}")
    if span != n or rel > 1e-4 or dP > 1e-3 or dX > 2e-2:
        raise AssertionError("phase3 sharded GBA disagrees with one device")
    iters = 8
    t1 = timed(lambda: single(iters)[2], n=3) / iters
    tn = timed(lambda: sharded(iters)[2], n=3) / iters
    log(f"{tag} phase3 GBA per LM iteration ({iters}-iteration solve): "
        f"1 card {t1 * 1e3:.3f} ms, {n} cards {tn * 1e3:.3f} ms "
        f"(speed-up {t1 / tn:.2f}x)")

    # (b) edge-sharded Sim3 pose graph vs the single-device optimizer, on a
    # ring of the GBA map's keyframe count (at 512 vertices the f32 Cholesky
    # of the 3584-wide ring system already differs by millimetres between
    # two reduction orders after one step)
    r = testing.posegraph_compare(n, K=64 if tiny else 128)
    log(f"{tag} phase3 pose graph K={r['K']}: max |ds| {r['ds']:.2e} (<= 1e-4),"
        f" |dt| {r['dt']:.2e} (<= 1e-3), |dR| {r['dR']:.2e} (<= 1e-3); "
        f"per LM iteration 1 card {r['t1'] * 1e3:.3f} ms, {n} cards "
        f"{r['tn'] * 1e3:.3f} ms; result spans {r['span']} devices")
    if r["span"] != n or r["ds"] > 1e-4 or r["dt"] > 1e-3 or r["dR"] > 1e-3:
        raise AssertionError("phase3 sharded pose graph disagrees")

    # (c) the pipeline's own mesh wiring at map scale
    psz = (dict(n_kf=16, n_pts=2048, obs_per_kf=256, max_kf=64, max_mp=2048,
                n_feat=256) if tiny else
           dict(n_kf=128, n_pts=12288, obs_per_kf=400, max_kf=512,
                max_mp=16384, n_feat=1024))
    r = testing.pipeline_mesh_compare(mesh, **psz)
    log(f"{tag} phase3 pipeline GBA ({psz['n_kf']} KF, {psz['n_pts']} pts, "
        f"landmarks moved up to {r['moved']:.3f} m): "
        f"max |dP| {r['dP']:.2e} m (<= 5e-3), max |dX| {r['dX']:.2e} m "
        f"(<= 2e-2); map on {r['span']} devices after the mesh run; 1 card "
        f"{r['t1']:.3f} s, {n} cards {r['tn']:.3f} s (compile included)")
    log(f"{tag} phase3 pipeline essential graph: max |dP| {r['dP_loop']:.2e} "
        f"m (<= 1e-3)")
    if r["dP"] > 5e-3 or r["dX"] > 2e-2 or r["dP_loop"] > 1e-3:
        raise AssertionError("phase3 pipeline mesh wiring disagrees")
    log(f"{tag} phase3 peak_bytes_in_use per device: {_peaks(devs[:n])}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only phase 3, on four devices")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU rehearsal: small profile, first 120 frames, "
                         "small problem sizes; gates reported, not "
                         "enforced")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    # ---- phase 0: device and environment ----
    import jax
    from mc_slam import runtime
    if args.tiny:
        jax.config.update("jax_platforms", "cpu")
        dev = jax.devices()[0]
        card = "no card (CPU rehearsal)"
    else:
        dev = runtime.use_gpu()
        card = card_name_and_power()
        cache = runtime.setup_compile_cache()
        log(f"phase0 compile cache: {cache}")
    cpu = jax.devices("cpu")[0]
    tag = f"[{card}]"
    log(f"phase0 card: {card}")
    log(f"phase0 device_kind {dev.device_kind}, platform {dev.platform}, "
        f"count {len(jax.devices())}, jax {jax.__version__}, XLA_FLAGS "
        f"{os.environ.get('XLA_FLAGS', '')!r}")

    if args.four:
        four_cards(tag, 4, args.tiny)
    else:
        from mc_slam.eval import clone
        # --tiny keeps the clone (its length sets the motion speed) and
        # tracks its first 120 frames at the small profile
        profile = "small" if args.tiny else "euroc"
        seconds = CLONE_SECONDS
        dataset = clone.dataset_dir(profile, seconds)
        t0 = time.perf_counter()
        gen = clone.start_dataset(dataset, seconds, profile)
        log(f"phase2 set-up: clone generation "
            f"{'started' if gen else 'found'} at {dataset}")
        try:
            cfg = clone.profile_config(profile)
            M, N = cfg.max_mp, cfg.n_feat
            check_hamming(dev, tag, N, M)
            check_projection_search(dev, tag, M, N)
            check_extract(dev, cpu, tag, cfg.n_feat, cfg.n_levels)
            check_idp_ba(dev, cpu, tag, *((6, 256, 64) if args.tiny
                                          else (20, 2048, 512)))
            log(f"phase1 done at {time.perf_counter() - t0:.1f} s")
            run_pipeline(tag, profile, dataset, gen, args.tiny)
        finally:
            if gen is not None and gen.poll() is None:
                gen.kill()
                gen.wait()
    log(f"card: {card}")
    print(runtime.result_line(jax.devices()), flush=True)


if __name__ == "__main__":
    main()
