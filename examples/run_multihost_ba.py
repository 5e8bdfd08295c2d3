#!/usr/bin/env python
"""Multi-process distributed Schur BA demo (BASELINE.json config #5), a
CPU-only demonstration of jax.distributed: every process pins the CPU
backend and never opens a GPU.

Each process initializes jax.distributed, joins a global mesh, and runs the
landmark-sharded Schur solve — landmarks partitioned per process, the dense
camera system reduced with one psum, solve replicated. Launch with --demo N
to spawn N processes on this machine over virtual CPU devices:

    python examples/run_multihost_ba.py --demo 2

Verifies every process computes the identical camera update and that it matches
a single-process reference solve.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def worker(coord, n_procs, pid, devices_per_proc):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count={devices_per_proc}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord, num_processes=n_procs,
                               process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from mc_slam.parallel import dist_ba
    from mc_slam.solver import lm

    n_dev = len(jax.devices())
    assert n_dev == n_procs * devices_per_proc, (n_dev, n_procs, devices_per_proc)
    mesh = Mesh(np.asarray(jax.devices()), ("mp",))

    # deterministic synthetic problem, identical on every process
    rng = np.random.default_rng(0)
    Nc, DC, Np, DP, obs_per_pt = 8, 6, 64 * n_dev, 3, 4
    O = Np * obs_per_pt
    obs = lm.Observations(
        cam=jnp.asarray(rng.integers(0, Nc, O), jnp.int32)[:, None],
        pt=jnp.asarray(np.repeat(np.arange(Np), obs_per_pt), jnp.int32),
        Jc=jnp.asarray(rng.normal(size=(O, 1, 2, DC)).astype(np.float32)),
        Jp=jnp.asarray(rng.normal(size=(O, 2, DP)).astype(np.float32)),
        r=jnp.asarray(rng.normal(size=(O, 2)).astype(np.float32)),
        w=jnp.asarray(rng.uniform(0.5, 2.0, O).astype(np.float32)))
    free = jnp.ones(Nc, jnp.float32).at[0].set(0.0)
    ptm = jnp.ones(Np, jnp.float32)
    Hc = jnp.zeros((Nc, DC, Nc, DC))
    gc = jnp.zeros((Nc, DC))

    dxc, dxp = dist_ba.dist_schur_solve(mesh, obs, Hc, gc, free, ptm, 1e-3,
                                        Nc, DC, Np, DP)
    dxc = np.asarray(jax.device_get(dxc))

    # single-device reference (process 0 only)
    if pid == 0:
        Hcc, g_c, Hpp, g_p, Wcp, _ = lm.build_landmark_system(obs, free, Nc, DC, Np, DP)
        ref, _ = lm.schur_solve(Hcc, g_c, Hpp, g_p, Wcp, 1e-3, free, ptm)
        err = np.abs(dxc - np.asarray(ref)).max()
        print(f"[proc {pid}] devices={n_dev} |dxc|={np.linalg.norm(dxc):.6f} "
              f"max err vs single-device: {err:.2e}")
        assert err < 5e-4, err
        print(f"[proc {pid}] MULTIHOST SCHUR OK")
    else:
        print(f"[proc {pid}] devices={n_dev} |dxc|={np.linalg.norm(dxc):.6f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", type=int, default=0,
                    help="spawn N local processes as a fake multi-host cluster")
    ap.add_argument("--coordinator", default="127.0.0.1:9876")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    args = ap.parse_args()

    if args.demo:
        procs = []
        for pid in range(args.demo):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--coordinator", args.coordinator,
                 "--num-processes", str(args.demo), "--process-id", str(pid),
                 "--devices-per-proc", str(args.devices_per_proc)]))
        rc = [p.wait() for p in procs]
        sys.exit(max(rc))
    worker(args.coordinator, args.num_processes, args.process_id,
           args.devices_per_proc)


if __name__ == "__main__":
    main()
