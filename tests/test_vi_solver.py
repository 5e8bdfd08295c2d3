"""VI optimizer + VI initialization tests on the synthetic analytic world."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.camera import make_camera
from mc_slam.imu.navstate import NavState
from mc_slam.imu.preintegration import (
    euroc_noise, preintegrate, preint_identity, predict_navstate)
from mc_slam.pipeline import viinit
from mc_slam.solver import ba, ba_vi, factors
from mc_slam.solver.ba import VisualObs

import synth

CAM = make_camera(400.0, 400.0, 320.0, 240.0, width=640, height=480)
EXT = factors.identity_extrinsics()  # body == camera
GW = jnp.asarray(synth.GW, jnp.float32)


def build_vi_window(rng, N_kf=8, kf_dt=0.25, noise_px=0.3, bg=np.zeros(3), ba_=np.zeros(3)):
    """Keyframes along the arc trajectory + preintegrations + observations."""
    traj = synth.Trajectory("arc", speed=1.2)
    noise = euroc_noise()
    pts = synth.make_landmarks(rng, n=250)
    kfs, pres = [], []
    for k in range(N_kf):
        t = k * kf_dt
        P, R = traj.pose(t)
        V = traj.velocity(t)
        kfs.append((t, P.astype(np.float32), R.astype(np.float32), V.astype(np.float32)))
        if k == 0:
            pres.append(preint_identity())
        else:
            rows = traj.imu_samples((k - 1) * kf_dt, k * kf_dt, bg=bg, ba=ba_)
            pres.append(preintegrate(jnp.asarray(rows), jnp.zeros(3), jnp.zeros(3), noise))
    pre_batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *pres)

    obs_cam, obs_pt, obs_uv = [], [], []
    for k, (t, P, R, V) in enumerate(kfs):
        uv, z = synth.project_points(CAM, R, P, pts)
        vis = synth.visible_mask(CAM, uv, z)
        for p in np.nonzero(vis)[0]:
            obs_cam.append(k); obs_pt.append(p)
            obs_uv.append(uv[p] + rng.normal(size=2) * noise_px)
    obs = VisualObs(
        cam=jnp.asarray(obs_cam, jnp.int32), pt=jnp.asarray(obs_pt, jnp.int32),
        uv=jnp.asarray(np.asarray(obs_uv, np.float32)),
        inv_sigma2=jnp.ones(len(obs_cam), jnp.float32),
        valid=jnp.ones(len(obs_cam), jnp.float32))
    return kfs, pre_batch, pts, obs


def kfs_to_navstate(kfs, bg=np.zeros(3), ba_=np.zeros(3)):
    P = jnp.asarray(np.stack([k[1] for k in kfs]))
    R = jnp.asarray(np.stack([k[2] for k in kfs]))
    V = jnp.asarray(np.stack([k[3] for k in kfs]))
    z = jnp.zeros_like(P)
    bgt = jnp.broadcast_to(jnp.asarray(bg, jnp.float32), P.shape)
    bat = jnp.broadcast_to(jnp.asarray(ba_, jnp.float32), P.shape)
    return NavState(P=P, V=V, R=R, bg=bgt, ba=bat, dbg=z, dba=z)


class TestVIBA:
    def test_window_ba_recovers_perturbation(self, rng):
        kfs, pre, pts, obs = build_vi_window(rng, N_kf=8)
        ns_true = kfs_to_navstate(kfs)
        N = 8
        # perturb all but the first two KFs
        dP = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
        dphi = rng.normal(size=(N, 3)).astype(np.float32) * 0.02
        dV = rng.normal(size=(N, 3)).astype(np.float32) * 0.05
        dP[:2] = 0; dphi[:2] = 0; dV[:2] = 0
        ns0 = ns_true._replace(
            P=ns_true.P + dP, V=ns_true.V + dV,
            R=ns_true.R @ lie.so3_exp(jnp.asarray(dphi)))
        pts0 = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05

        edges = ba_vi.IMUEdges(
            i=jnp.arange(0, N - 1, dtype=jnp.int32),
            j=jnp.arange(1, N, dtype=jnp.int32),
            pre=jax.tree_util.tree_map(lambda a: a[1:], pre),
            info_prv=ba_vi.factors.imu_prv_info(
                jax.tree_util.tree_map(lambda a: a[1:], pre)),
            info_bias=ba_vi.factors.bias_rw_info(pre.dT[1:], 2e-5, 5e-3),
            valid=jnp.ones(N - 1, jnp.float32))
        free = jnp.asarray([0.0, 0.0] + [1.0] * (N - 2), jnp.float32)
        ns, pts_e, chi2, cost = ba_vi.vi_ba(
            ns0, jnp.asarray(pts0), obs, edges, CAM, EXT, GW, free,
            jnp.ones(pts.shape[0], jnp.float32), iters=12)
        p_err0 = np.abs(np.asarray(ns0.P) - np.asarray(ns_true.P)).max()
        p_err = np.abs(np.asarray(ns.P) - np.asarray(ns_true.P)).max()
        assert p_err < 0.02, (p_err0, p_err)
        v_err = np.abs(np.asarray(ns.V) - np.asarray(ns_true.V)).max()
        assert v_err < 0.06, v_err

    def test_bias_observability(self, rng):
        """With a gyro bias injected into the IMU, poses pinned by strong vision
        (fixed points), and a *weak* bias random walk, VI BA must absorb the
        misfit into the delta-bias states — exercising the bias columns of the
        PRV factor. (With the reference's tight RW sigma of 2e-5 the chain is
        pinned to the fixed KF's zero bias — that regime is what VI-init is for.)"""
        bg_true = np.array([0.01, -0.015, 0.02], np.float32)
        kfs, pre, pts, obs = build_vi_window(rng, N_kf=8, bg=bg_true, noise_px=0.1)
        ns0 = kfs_to_navstate(kfs)  # states at truth, bias state zero
        N = 8
        obs = obs._replace(inv_sigma2=obs.inv_sigma2 * 100.0)  # strong vision pin
        edges = ba_vi.IMUEdges(
            i=jnp.arange(0, N - 1, dtype=jnp.int32),
            j=jnp.arange(1, N, dtype=jnp.int32),
            pre=jax.tree_util.tree_map(lambda a: a[1:], pre),
            info_prv=ba_vi.factors.imu_prv_info(
                jax.tree_util.tree_map(lambda a: a[1:], pre)),
            info_bias=ba_vi.factors.bias_rw_info(pre.dT[1:], 5e-3, 5e-2),
            valid=jnp.ones(N - 1, jnp.float32))
        free = jnp.asarray([0.0] + [1.0] * (N - 1), jnp.float32)
        ns, pts_e, chi2, cost = ba_vi.vi_ba(
            ns0, jnp.asarray(pts), obs, edges, CAM, EXT, GW, free,
            jnp.ones(pts.shape[0], jnp.float32), iters=15, fix_points=True)
        # delta-bias of later free KFs should approach the injected bias
        dbg = np.asarray(ns.dbg)[3:]
        np.testing.assert_allclose(dbg.mean(axis=0), bg_true, atol=4e-3)
        # and the poses must not have warped away from truth
        ns_true = kfs_to_navstate(kfs)
        assert np.abs(np.asarray(ns.P) - np.asarray(ns_true.P)).max() < 0.03


class TestPoseOnlyVI:
    def test_tracks_with_imu_prior(self, rng):
        kfs, pre, pts, obs = build_vi_window(rng, N_kf=3, kf_dt=0.2)
        ns_all = kfs_to_navstate(kfs)
        ns_last = jax.tree_util.tree_map(lambda a: a[1], ns_all)
        ns_cur_true = jax.tree_util.tree_map(lambda a: a[2], ns_all)
        pre12 = jax.tree_util.tree_map(lambda a: a[2], pre)
        # predict current from last by IMU, then optimize against the map
        ns_cur0 = predict_navstate(ns_last, pre12, GW)
        mask2 = np.asarray(obs.cam) == 2
        idx = np.nonzero(mask2)[0]
        obs2 = VisualObs(cam=jnp.zeros(len(idx), jnp.int32), pt=obs.pt[idx],
                         uv=obs.uv[idx], inv_sigma2=obs.inv_sigma2[idx],
                         valid=obs.valid[idx])
        prior = ba_vi.PriorFactor(
            cam=jnp.asarray(0, jnp.int32), ns0=ns_last,
            info=jnp.eye(15, dtype=jnp.float32) * 1e4,
            valid=jnp.asarray(1.0, jnp.float32))
        info_prv = ba_vi.factors.imu_prv_info(pre12)
        info_bias = ba_vi.factors.bias_rw_info(pre12.dT, 2e-5, 5e-3)
        ns_cur, chi2, n_in, H_marg = ba_vi.pose_only_vi(
            ns_cur0, ns_last, pre12, jnp.asarray(pts), obs2, CAM, EXT, GW,
            prior, info_prv, info_bias, iters=25)
        np.testing.assert_allclose(np.asarray(ns_cur.P), np.asarray(ns_cur_true.P), atol=2e-2)
        assert int(n_in) > 0.9 * len(idx)
        # marginal info must be symmetric PSD and nontrivial
        Hm = np.asarray(H_marg, np.float64)
        np.testing.assert_allclose(Hm, Hm.T, atol=1e-3 * np.abs(Hm).max())
        w = np.linalg.eigvalsh(0.5 * (Hm + Hm.T))
        assert w.min() > -1e-3 * max(w.max(), 1.0)


class TestVIInit:
    def _window(self, rng, N_kf=20, kf_dt=0.5, bg=np.zeros(3), ba_=np.zeros(3)):
        return build_vi_window(rng, N_kf=N_kf, kf_dt=kf_dt, noise_px=0.0,
                               bg=bg, ba_=ba_)

    def test_gyro_bias_estimation(self, rng):
        bg_true = np.array([0.02, -0.01, 0.015], np.float32)
        kfs, pre, pts, obs = self._window(rng, N_kf=12, bg=bg_true)
        Rwb = jnp.asarray(np.stack([k[2] for k in kfs]))
        valid = jnp.asarray([0.0] + [1.0] * 11, jnp.float32)
        bg = viinit.estimate_gyro_bias(Rwb, pre, valid)
        np.testing.assert_allclose(np.asarray(bg), bg_true, atol=1e-3)

    def test_full_init_recovers_scale_gravity_bias(self, rng):
        bg_true = np.array([0.015, -0.02, 0.01], np.float32)
        ba_true = np.array([0.05, -0.08, 0.06], np.float32)
        kfs, pre, pts, obs = self._window(rng, N_kf=20, kf_dt=0.4,
                                          bg=bg_true, ba_=ba_true)
        scale_true = 2.5
        # visual poses: body==camera here, but the "visual world" is scaled down
        Pwc = jnp.asarray(np.stack([k[1] for k in kfs]) / scale_true)
        Rwc = jnp.asarray(np.stack([k[2] for k in kfs]))
        valid = jnp.asarray([0.0] + [1.0] * 19, jnp.float32)
        res = viinit.try_init_vio(Pwc, Rwc, pre, valid,
                                  jnp.eye(3), jnp.zeros(3), g_mag=synth.G)
        np.testing.assert_allclose(np.asarray(res.bg), bg_true, atol=2e-3)
        np.testing.assert_allclose(float(res.scale), scale_true, rtol=0.05)
        np.testing.assert_allclose(np.asarray(res.gw), synth.GW, atol=0.15)
        np.testing.assert_allclose(np.asarray(res.ba), ba_true, atol=0.05)

    def test_velocities(self, rng):
        kfs, pre, pts, obs = self._window(rng, N_kf=10, kf_dt=0.3)
        Pwc = jnp.asarray(np.stack([k[1] for k in kfs]))
        Rwc = jnp.asarray(np.stack([k[2] for k in kfs]))
        V_true = np.stack([k[3] for k in kfs])
        valid = jnp.asarray([0.0] + [1.0] * 9, jnp.float32)
        V = viinit.compute_velocities(Pwc, Rwc, pre, valid, jnp.eye(3), jnp.zeros(3),
                                      jnp.asarray(1.0), GW, jnp.zeros(3))
        np.testing.assert_allclose(np.asarray(V), V_true, atol=0.05)

    def test_padded_init_matches_unpadded(self, rng):
        """Bucket-padding the keyframe window (valid=0 rows duplicating the
        last real keyframe) must not change any init output — the pipeline
        pads to a fixed bucket so init attempts don't recompile per count."""
        bg_true = np.array([0.01, -0.015, 0.02], np.float32)
        kfs, pre, pts, obs = self._window(rng, N_kf=14, kf_dt=0.4, bg=bg_true)
        Pwc = jnp.asarray(np.stack([k[1] for k in kfs]) / 2.0)
        Rwc = jnp.asarray(np.stack([k[2] for k in kfs]))
        valid = jnp.asarray([0.0] + [1.0] * 13, jnp.float32)
        res = viinit.try_init_vio(Pwc, Rwc, pre, valid, jnp.eye(3),
                                  jnp.zeros(3), g_mag=synth.G)
        pad = 6
        dup = lambda a: jnp.concatenate(
            [a, jnp.broadcast_to(a[-1], (pad,) + a.shape[1:])], 0)
        pre_p = jax.tree_util.tree_map(dup, pre)
        valid_p = jnp.concatenate([valid, jnp.zeros(pad)])
        res_p = viinit.try_init_vio(dup(Pwc), dup(Rwc), pre_p, valid_p,
                                    jnp.eye(3), jnp.zeros(3), g_mag=synth.G)
        for a, b in zip(res, res_p):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-5)
        V = viinit.compute_velocities(Pwc, Rwc, pre, valid, jnp.eye(3),
                                      jnp.zeros(3), res.scale, res.gw, res.ba)
        V_p = viinit.compute_velocities(dup(Pwc), dup(Rwc), pre_p, valid_p,
                                        jnp.eye(3), jnp.zeros(3), res_p.scale,
                                        res_p.gw, res_p.ba)
        np.testing.assert_allclose(np.asarray(V_p[:14]), np.asarray(V),
                                   rtol=1e-4, atol=1e-5)
