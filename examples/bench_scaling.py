#!/usr/bin/env python
"""Scaling report for the distributed whole-map BA, in two parts.

  A. DEVICE COMPUTE at map scale — the single-device landmark-chunked VI GBA
     per-iteration time on the GPU, on the real map when a checkpoint from
     a clone run exists (eval_clone --save-ckpt, .data/clone_ckpt.npz),
     else on the synthetic problem at the same scale
     (bench_problems.gba_map_problem: 128 KF / 12k pts / ~50k obs).
  B. COMM STRUCTURE on an 8-virtual-device CPU mesh (a child process that
     stays on the CPU) — validates that the sharded program executes the
     same math (equality is separately asserted in tests/test_parallel.py);
     its wall clock is NOT a scaling measurement and is labeled as such.

The measured multi-card number comes from `chip_smoke.py --four`, which runs
the sharded GBA on four cards against one. Prints one JSON line.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CKPT = os.path.join(os.path.dirname(__file__), "..", ".data",
                    "clone_ckpt.npz")


def timeit(f, n=3, warm=1):
    import jax
    for _ in range(warm):
        jax.block_until_ready(f())
    t0 = time.perf_counter()
    for _ in range(n):
        out = f()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def build_problem():
    """(ns, pts, cobs, edges, cam, ext, gw, free, pt_mask, meta) at map
    scale — from the flagship checkpoint when present."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mc_slam.solver import ba_chunked, factors
    from mc_slam.solver.ba_vi import IMUEdges
    from mc_slam.camera import euroc_camera

    if os.path.exists(CKPT):
        from mc_slam.io.checkpoint import load_map
        m, extra = load_map(CKPT)
        act = [s for s in extra["kf_slots"]]
        Nc = len(act)
        ks = jnp.asarray(act, jnp.int32)
        ns = jax.tree_util.tree_map(lambda a: a[ks], m.kf_ns)
        Fn = m.F
        cam_idx = np.repeat(np.arange(Nc, dtype=np.int32), Fn)
        mp = np.asarray(m.kf_mp)[act].reshape(-1)
        uv = np.asarray(m.kf_uv)[act].reshape(-1, 2)
        lvl = np.asarray(m.kf_level)[act].reshape(-1)
        fv = np.asarray(m.kf_feat_valid)[act].reshape(-1)
        valid = ((mp >= 0) & fv).astype(np.float32)
        inv_s2 = 1.0 / (1.2 ** (2.0 * lvl.astype(np.float32)))
        Np_ = m.P
        n_chunks = 16 * max(1, Np_ // (16 * 1024))
        n_chunks = int(np.ceil(n_chunks / 8)) * 8
        cobs, C = ba_chunked.chunk_observations(
            cam_idx, np.clip(mp, 0, Np_ - 1), uv, inv_s2, valid, Np_,
            n_chunks)
        # IMU chain edges over consecutive keyframes
        pre = jax.tree_util.tree_map(lambda a: a[ks[1:]], m.kf_preint)
        info_prv = factors.imu_prv_info(pre)
        from mc_slam.imu.preintegration import euroc_noise
        noise = euroc_noise()
        info_bias = factors.bias_rw_info(pre.dT, float(noise.sigma_bg),
                                         float(noise.sigma_ba))
        edges = IMUEdges(i=jnp.arange(0, Nc - 1, dtype=jnp.int32),
                         j=jnp.arange(1, Nc, dtype=jnp.int32),
                         pre=pre, info_prv=info_prv, info_bias=info_bias,
                         valid=jnp.ones(Nc - 1, jnp.float32))
        free = jnp.ones(Nc, jnp.float32).at[0].set(0.0)
        pt_mask = m.mp_active.astype(jnp.float32)
        gw = jnp.asarray(extra.get("gw", [0, 0, -9.81]), jnp.float32)
        meta = {"source": f"checkpoint:{CKPT}", "n_kf": Nc, "n_pts": int(Np_),
                "n_obs": int(valid.sum()), "chunks": n_chunks}
        return (ns, m.mp_pos, cobs, edges, euroc_camera(),
                factors.identity_extrinsics(), gw, free, pt_mask, meta)
    # fallback: synthetic at euroc-map scale
    from mc_slam.bench_problems import gba_map_problem
    return gba_map_problem()


def mesh_sub():
    """Subprocess body: 8-virtual-CPU-device mesh run (comm structure)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa
    from mc_slam.parallel import dist_ba, dist_gba
    from mc_slam.solver import ba_chunked
    iters = 4
    (ns, pts, cobs, edges, cam, ext, gw, free, ptm, meta) = build_problem()
    n_dev = len(jax.devices())
    mesh = dist_ba.make_mesh(n_dev)
    cobs_s = dist_gba.shard_chunked_obs(mesh, cobs)

    def sharded():
        _, _, cost = dist_gba.vi_gba_chunked_sharded(
            mesh, ns, pts, cobs_s, edges, cam, ext, gw, free, ptm,
            iters=iters)
        return cost

    def single():
        _, _, cost = ba_chunked.vi_gba_chunked(
            ns, pts, cobs, edges, cam, ext, gw, free, ptm, iters=iters)
        return cost

    t1 = timeit(single, n=2)
    tn = timeit(sharded, n=2)
    print(json.dumps({"cpu_mesh_devices": n_dev,
                      "cpu_iters_s_1dev": round(iters / t1, 2),
                      "cpu_iters_s_mesh": round(iters / tn, 2)}))


def main():
    if "--mesh-sub" in sys.argv:
        return mesh_sub()
    import jax
    from mc_slam import runtime
    runtime.use_gpu()
    runtime.setup_compile_cache()
    from mc_slam.solver import ba_chunked
    from mc_slam.solver.ba_vi import DC

    iters = 8
    (ns, pts, cobs, edges, cam, ext, gw, free, ptm, meta) = build_problem()

    # A: single-device compute at map scale on the real accelerator
    def single():
        _, _, cost = ba_chunked.vi_gba_chunked(
            ns, pts, cobs, edges, cam, ext, gw, free, ptm, iters=iters)
        return cost

    t1 = timeit(single)
    t_iter = t1 / iters

    # collective volume per iteration (exact for this program): one psum of
    # the reduced camera system + one all_gather of the landmark update
    Nc = ns.P.shape[0]
    Np = pts.shape[0]
    d = Nc * DC
    psum_bytes = (d * d + d + d + 1) * 4
    ag_bytes = Np * 3 * 4

    # B: CPU-mesh structural run (a child on the CPU with 8 virtual devices;
    # it never opens the card)
    env = dict(os.environ)
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "") + \
        " --xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--mesh-sub"], capture_output=True, text=True,
                       timeout=1200, env=env, check=True)
    cpu_part = json.loads(r.stdout.strip().splitlines()[-1])

    ca = jax.jit(single).lower().compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0)) / iters

    out = {
        "problem": meta,
        "device": runtime.device_info(jax.devices()),
        "measured_iter_ms_1dev": 1e3 * t_iter,
        "comm_per_iter_bytes": {"psum_reduced_system": psum_bytes,
                                "all_gather_landmarks": ag_bytes},
        "flops_per_iter": flops,
        "cpu_mesh_structural": {**cpu_part,
                                "note": "virtual devices share host cores; "
                                        "validates the sharded program, NOT "
                                        "a throughput measurement"},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
