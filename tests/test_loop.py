"""BoW place recognition + Sim3 pose-graph tests."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam import lie
from mc_slam.frontend import bow, orb
from mc_slam.solver import posegraph


def rand_desc(rng, n):
    words = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    return orb.unpack_pm1(jnp.asarray(words))


class TestBow:
    def test_same_scene_scores_higher(self, rng):
        vocab = bow.random_vocab(jax.random.PRNGKey(0))
        base = rand_desc(rng, 300)
        valid = jnp.ones(300)
        # view B: same scene, 30% features replaced; view C: different scene
        other = rand_desc(rng, 300)
        mask = jnp.asarray(rng.random(300) < 0.3)
        vb = jnp.where(mask[:, None], other, base)
        vc = rand_desc(rng, 300)
        ha = bow.bow_histogram(base, valid, vocab)
        hb = bow.bow_histogram(vb, valid, vocab)
        hc = bow.bow_histogram(vc, valid, vocab)
        assert float(ha @ hb) > float(ha @ hc) + 0.2

    def test_train_vocab_improves_separation(self, rng):
        descs = rand_desc(rng, 1024)
        valid = jnp.ones(1024)
        vocab = bow.train_vocab(descs, valid, jax.random.PRNGKey(1), n_words=128,
                                iters=3)
        assert vocab.shape == (128, 256)
        h = bow.bow_histogram(descs, valid, vocab)
        # trained vocab spreads mass across many words
        assert float((h > 0).sum()) > 32

    def test_score_all_masks(self, rng):
        vocab = bow.random_vocab(jax.random.PRNGKey(0), 256)
        d = rand_desc(rng, 100)
        h = bow.bow_histogram(d, jnp.ones(100), vocab)
        hists = jnp.stack([h, h * 0.5, h])
        scores = bow.score_all(h, hists, jnp.asarray([True, True, False]))
        assert float(scores[2]) == -1.0
        assert float(scores[0]) >= float(scores[1])


class TestPoseGraph:
    def _chain_with_drift(self, rng, K=12, drift=0.02):
        """Ground-truth loop: KFs on a circle; odometry edges with accumulated
        drift; a loop edge closing K-1 -> 0."""
        angles = np.linspace(0, 2 * np.pi * (K - 1) / K, K)
        P_gt = np.stack([np.cos(angles), np.sin(angles), np.zeros(K)], 1).astype(np.float32)
        R_gt = np.stack([np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
                         for a in angles])
        # vertices: Scw = (R^T, -R^T P), s=1
        Rcw = np.swapaxes(R_gt, 1, 2)
        tcw = -np.einsum('kij,kj->ki', Rcw, P_gt)
        return P_gt, R_gt, Rcw.astype(np.float32), tcw.astype(np.float32)

    def test_loop_closure_removes_drift(self, rng):
        K = 12
        P_gt, R_gt, Rcw, tcw = self._chain_with_drift(rng)
        dtype = jnp.float32
        s_gt = jnp.ones(K, dtype)
        R_v = jnp.asarray(Rcw)
        t_v = jnp.asarray(tcw)
        # true sequential measurements
        ei = jnp.arange(0, K - 1, dtype=jnp.int32)
        ej = jnp.arange(1, K, dtype=jnp.int32)
        sm, Rm, tm = posegraph.edge_measurement(
            s_gt[ei], R_v[ei], t_v[ei], s_gt[ej], R_v[ej], t_v[ej])
        # corrupt the vertex estimates with accumulated drift (scale + yaw + pos)
        drift_R = np.stack([np.asarray(lie.so3_exp(jnp.asarray(
            [0.0, 0.0, 0.02 * k], jnp.float32))) for k in range(K)])
        s0 = jnp.asarray(1.0 + 0.01 * np.arange(K), dtype)
        R0 = jnp.asarray(np.einsum('kij,kjl->kil', Rcw, drift_R))
        t0 = t_v + jnp.asarray(0.03 * rng.normal(size=(K, 3)).astype(np.float32))
        t0 = t0.at[0].set(t_v[0])  # vertex 0 is the fixed gauge: keep it at truth
        # loop edge K-1 -> 0 with the TRUE relative measurement
        sl, Rl, tl = posegraph.edge_measurement(
            s_gt[K - 1:K], R_v[K - 1:], t_v[K - 1:], s_gt[:1], R_v[:1], t_v[:1])
        g = posegraph.Sim3Graph(
            s=s0, R=R0, t=t0,
            ei=jnp.concatenate([ei, jnp.asarray([K - 1], jnp.int32)]),
            ej=jnp.concatenate([ej, jnp.asarray([0], jnp.int32)]),
            s_m=jnp.concatenate([sm, sl]), R_m=jnp.concatenate([Rm, Rl]),
            t_m=jnp.concatenate([tm, tl]),
            w=jnp.ones(K, dtype), free=jnp.ones(K, dtype).at[0].set(0.0))
        R_new, s_new, t_new, cost = posegraph.optimize_pose_graph(g, iters=30)
        assert float(cost) < 1e-6, float(cost)
        # scale drift removed
        np.testing.assert_allclose(np.asarray(s_new), 1.0, atol=2e-3)
        # positions recovered (vertex 0 was fixed with its ORIGINAL estimate —
        # but vertex 0 was also corrupted only in ei>0 terms; allow alignment)
        P_est = -np.einsum('kji,kj->ki', np.asarray(R_new), np.asarray(t_new)) \
            / np.asarray(s_new)[:, None]
        err = np.linalg.norm(P_est - P_gt, axis=1)
        assert err.max() < 0.05, err

    def test_correct_map_points(self, rng):
        K = 4
        s_old = jnp.ones(K)
        R_old = jnp.broadcast_to(jnp.eye(3), (K, 3, 3))
        t_old = jnp.zeros((K, 3))
        # new: shift everything by +1 in x (Scw t = -1 -> world shifts +1)
        s_new = jnp.ones(K)
        R_new = R_old
        t_new = jnp.zeros((K, 3)).at[:, 0].set(-1.0)
        pts = jnp.asarray(rng.normal(size=(10, 3)).astype(np.float32))
        ref = jnp.zeros(10, jnp.int32)
        out = posegraph.correct_map_points(pts, ref, s_old, R_old, t_old,
                                           s_new, R_new, t_new)
        np.testing.assert_allclose(np.asarray(out), np.asarray(pts) + [1, 0, 0],
                                   atol=1e-6)


class TestTrainedVocabArtifact:
    """VERDICT round-1 item 8: a shipped vocabulary artifact with measured
    recall on held-out revisits at >=1024-feature scale (the ORBvoc role,
    TemplatedVocabulary.h:1467)."""

    def test_artifact_loads(self):
        v = bow.load_default_vocab()
        assert v.shape[1] == 256
        # artifact (4096 trained words) present, not the random fallback
        assert v.shape[0] >= 2048

    def test_heldout_revisit_recall(self, rng):
        """Score matrix over held-out room views: for every query, the same
        place under a different pose must out-rank all other places."""
        import jax.numpy as jnp
        from mc_slam.camera import make_camera
        from mc_slam.frontend import extractor
        from mc_slam.sim import RoomWorld
        cam = make_camera(400.0, 400.0, 376.0, 240.0, width=752, height=480)
        world = RoomWorld(np.random.default_rng(777), tex_size=512)  # held out
        vocab = bow.load_default_vocab()
        # 6 distinct places; 2 views each (shifted + slightly rotated)
        places = [(np.array([x, y, 1.5]), yaw) for x, y, yaw in
                  [(-6, -2, 0.0), (-2, 2, 1.2), (2, -2, 2.4),
                   (6, 2, 3.6), (0, 0, 4.8), (-4, 3, 5.7)]]
        hists = []
        from mc_slam import lie
        for C, yaw in places:
            for d_yaw, dC in ((0.0, np.zeros(3)), (0.12, np.array([0.3, 0.2, 0.05]))):
                R = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, yaw + d_yaw],
                                                       jnp.float32)))
                # camera looks along +z after a fixed x-rotation; use yaw about z
                Rz = np.asarray(lie.so3_exp(jnp.asarray([np.pi / 2, 0.0, 0.0],
                                                        jnp.float32)))
                img = world.render(cam, (R @ Rz).astype(np.float32),
                                   (C + dC).astype(np.float32))
                f = extractor.extract(jnp.asarray(img, jnp.float32),
                                      n_features=1024, n_levels=8)
                hists.append(np.asarray(bow.bow_histogram(
                    f.desc_pm1, f.valid.astype(jnp.float32), vocab)))
        H = np.stack(hists)          # (12, W) — pairs (2i, 2i+1) are same place
        S = H @ H.T
        np.fill_diagonal(S, -1.0)
        hits = 0
        for q in range(12):
            partner = q ^ 1
            if S[q].argmax() == partner:
                hits += 1
        recall = hits / 12.0
        assert recall >= 0.9, (recall, S.round(3))


class TestEssentialGraphPersistence:
    """Persistent loop edges: closure #2 must not re-open the seam healed by
    closure #1 (LoopClosing.cpp:710-711 stores each closure on both KFs;
    OptimizeEssentialGraph re-includes them, Optimizer.cpp:4413-4420)."""

    def _make_map(self, K=16):
        from mc_slam.slam_map.mapstate import empty_map
        m = empty_map(max_kf=K, max_mp=64, n_feat=32)
        # ground truth: a closed circle; KF K-1 lands next to KF 0
        ang = np.linspace(0, 2 * np.pi * (K - 1) / K, K).astype(np.float32)
        P_gt = np.stack([np.cos(ang), np.sin(ang), np.zeros(K)], 1)
        R_gt = np.stack([np.asarray(lie.so3_exp(
            jnp.asarray([0.0, 0.0, a], jnp.float32))) for a in ang])
        return m, P_gt.astype(np.float32), R_gt.astype(np.float32)

    def _drift(self, P, R, start, stop=None, per_kf_yaw=0.03, per_kf_t=0.04):
        """Accumulate yaw+translation drift onto KFs start..stop."""
        P, R = P.copy(), R.copy()
        stop = len(P) if stop is None else stop
        for k in range(start, stop):
            a = per_kf_yaw * (k - start + 1)
            d = per_kf_t * (k - start + 1)
            Rg = np.asarray(lie.so3_exp(jnp.asarray([0, 0, a], jnp.float32)))
            P[k] = Rg @ P[k] + np.array([d, 0, 0], np.float32)
            R[k] = Rg @ R[k]
        return P, R

    def _rel(self, m, a, b):
        """Relative SE3 (R_ab, t_ab) between keyframes a, b from MapState."""
        P = np.asarray(m.kf_ns.P)
        R = np.asarray(m.kf_ns.R)
        return R[a].T @ R[b], R[a].T @ (P[b] - P[a])

    def _measurement(self, P_gt, R_gt, loop, cur):
        # vertices Scw at TRUE poses; edge S_cur * S_loop^{-1}
        Rcw = np.swapaxes(R_gt, 1, 2)
        tcw = -np.einsum('kij,kj->ki', Rcw, P_gt)
        s = jnp.ones(len(P_gt), jnp.float32)
        sm, Rm, tm = posegraph.edge_measurement(
            s[loop], jnp.asarray(Rcw[loop]), jnp.asarray(tcw[loop]),
            s[cur], jnp.asarray(Rcw[cur]), jnp.asarray(tcw[cur]))
        from mc_slam.geometry.sim3solver import Sim3Result
        return Sim3Result(ok=jnp.asarray(True), s=sm, R=Rm, t=tm,
                          inliers=jnp.ones(1), n_inliers=jnp.asarray(50))

    def _run(self, persist):
        from mc_slam.camera import make_camera
        from mc_slam.pipeline import loopclosing
        K = 16
        cam = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
        m, P_gt, R_gt = self._make_map(K)
        P_est, R_est = self._drift(P_gt, R_gt, start=6)
        ns = m.kf_ns._replace(P=jnp.asarray(P_est), R=jnp.asarray(R_est))
        m = m._replace(kf_ns=ns, kf_active=jnp.ones(K, bool),
                       kf_id=jnp.arange(K, dtype=jnp.int32))
        slots = list(range(K))
        # closure #1: KF 15 <-> KF 0 with the true relative measurement
        mm = loopclosing.close_loop(m, slots, 15, 0,
                                    self._measurement(P_gt, R_gt, 0, 15),
                                    cam, fix_scale=True)
        R_ab1, t_ab1 = self._rel(mm, 0, 15)
        # truth for the pair
        R_gt_ab = R_gt[0].T @ R_gt[15]
        t_gt_ab = R_gt[0].T @ (P_gt[15] - P_gt[0])
        assert np.linalg.norm(t_ab1 - t_gt_ab) < 0.15
        # inject NEW drift on the middle stretch ONLY (the healed 0<->15 seam
        # keeps its relative pose, as it would under BA: the fused cross-seam
        # points hold it), then closure #2: 10 <-> 3. Without the persisted
        # edge, closure #2's correction distributes along the whole chain —
        # including across the seam — and re-opens it.
        P2 = np.asarray(mm.kf_ns.P)
        R2 = np.asarray(mm.kf_ns.R)
        P2d, R2d = self._drift(P2, R2, start=6, stop=13,
                               per_kf_yaw=0.02, per_kf_t=0.03)
        mm = mm._replace(kf_ns=mm.kf_ns._replace(P=jnp.asarray(P2d),
                                                 R=jnp.asarray(R2d)))
        R_ab_pre, t_ab_pre = self._rel(mm, 0, 15)
        assert np.linalg.norm(t_ab_pre - t_ab1) < 1e-5   # seam untouched
        mm = loopclosing.close_loop(
            mm, slots, 10, 3, self._measurement(P_gt, R_gt, 3, 10), cam,
            fix_scale=True, loop_edges=[(0, 15)] if persist else None)
        R_ab2, t_ab2 = self._rel(mm, 0, 15)
        return np.linalg.norm(t_ab2 - t_gt_ab), float(np.arccos(np.clip(
            (np.trace(R_gt_ab.T @ R_ab2) - 1) / 2, -1, 1)))

    def test_first_loop_survives_second(self):
        err_p, err_r = self._run(persist=True)
        err_p0, err_r0 = self._run(persist=False)
        # with the persisted edge, the healed seam must stay closed...
        assert err_p < 0.2 and err_r < 0.1
        # ...and strictly tighter than the forgetful graph
        assert err_p <= err_p0 + 1e-6


class TestSim3VerifyBatch:
    """Batched per-event Sim3 candidate RANSAC (sim3_ransac_batch) + the
    separate guided-group gate (the reference iterates candidates
    sequentially, ComputeSim3 src/LoopClosing.cpp:277-330; here one device
    program serves every candidate)."""

    def test_identity_pair_and_pad_bar(self, rng):
        from mc_slam.camera import euroc_camera
        from mc_slam.pipeline import loopclosing
        from mc_slam.slam_map.mapstate import empty_map

        cam = euroc_camera()
        m = empty_map(max_kf=8, max_mp=512, n_feat=256)
        pts = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1, 1, 200),
                        rng.uniform(3, 6, 200)], 1).astype(np.float32)
        pm1 = rand_desc(rng, 200)
        m = m._replace(
            mp_pos=jnp.zeros((512, 3)).at[:200].set(pts),
            mp_active=jnp.arange(512) < 200,
            mp_pm1=jnp.zeros((512, 256), jnp.int8).at[:200].set(pm1))
        u = cam.fx * pts[:, 0] / pts[:, 2] + cam.cx
        v = cam.fy * pts[:, 1] / pts[:, 2] + cam.cy
        uv = jnp.stack([u, v], 1)
        idx200 = jnp.arange(200)
        m = m._replace(
            kf_mp=jnp.full((8, 256), -1, jnp.int32)
            .at[0, :200].set(idx200).at[1, :200].set(idx200),
            kf_uv=jnp.zeros((8, 256, 2)).at[0, :200].set(uv).at[1, :200].set(uv),
            kf_pm1=jnp.zeros((8, 256, 256), jnp.int8)
            .at[0, :200].set(pm1).at[1, :200].set(pm1),
            kf_feat_valid=jnp.zeros((8, 256), bool)
            .at[0, :200].set(True).at[1, :200].set(True),
            kf_active=jnp.zeros(8, bool).at[0].set(True).at[1].set(True))
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        packed = np.asarray(loopclosing.sim3_ransac_batch(
            m, keys, jnp.asarray(1, jnp.int32),
            jnp.asarray([0, 0, 0], jnp.int32),
            jnp.asarray([20, 20, 1 << 20], jnp.int32), cam, fix_scale=True))
        ok = packed[:, 0] > 0.5
        n_in = packed[:, 1]
        s = packed[:, 2]
        R = packed[:, 3:12].reshape(-1, 3, 3)
        t = packed[:, 12:15]
        # same scene, identity relative pose: candidate passes with S = I
        assert ok[0] and ok[1]
        assert np.allclose(R[0], np.eye(3), atol=1e-2)
        assert np.allclose(t[0], 0.0, atol=1e-2)
        assert np.allclose(s[0], 1.0)
        # the pad row's unreachable consensus bar must reject it
        assert not ok[2]
        # the guided-group verification gate on the passing candidate
        ng = int(loopclosing.guided_match_count(
            m, jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32),
            jnp.asarray([0] * 5, jnp.int32), jnp.asarray(s[0]),
            jnp.asarray(R[0]), jnp.asarray(t[0]), cam))
        assert ng >= 40
