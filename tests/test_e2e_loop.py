"""Loop-closure end-to-end: a panoramic circuit (camera orbits a small ring
inside a cylindrical dot world, panning 360 degrees). Old scenery leaves the
FOV entirely during the sweep; meanwhile a small per-frame Sim3 drift is
injected into everything created after a cutoff (the inconsistency real mono
drift accumulates). On revisit the two map halves disagree by far more than the
match window — only BoW detection + Sim3 + pose-graph correction can close the
seam."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_slam import lie
from mc_slam.camera import make_camera
from mc_slam.pipeline.system import SlamConfig, SlamSystem, OK

CAM = make_camera(300.0, 300.0, 240.0, 180.0, width=480, height=360)
T_LOOP = 24.0   # seconds for the full 360-degree sweep (pan ~8 px/frame)
R_ORBIT = 0.8
R_CYL = 6.0


class CylinderWorld:
    def __init__(self, rng, n=1400, patch=9):
        phi = rng.uniform(0, 2 * np.pi, n)
        y = rng.uniform(-2.5, 2.5, n)
        self.pts = np.stack([R_CYL * np.sin(phi), y, R_CYL * np.cos(phi)], 1).astype(np.float32)
        self.patches = rng.uniform(40, 255, size=(n, patch, patch)).astype(np.float32)
        self.r = patch // 2

    def render(self, Rwc, Cw, background=35.0):
        H, W, r = 360, 480, self.r
        img = np.full((H, W), background, np.float32)
        Pc = (np.asarray(Rwc).T @ (self.pts - np.asarray(Cw)).T).T
        vis = Pc[:, 2] > 0.5
        u = (300.0 * Pc[:, 0] / np.maximum(Pc[:, 2], 1e-6) + W / 2).astype(int)
        v = (300.0 * Pc[:, 1] / np.maximum(Pc[:, 2], 1e-6) + H / 2).astype(int)
        for i in np.nonzero(vis)[0]:
            if r + 1 <= u[i] < W - r - 1 and r + 1 <= v[i] < H - r - 1:
                img[v[i] - r:v[i] + r + 1, u[i] - r:u[i] + r + 1] = self.patches[i]
        return img


def pose(t):
    theta = 2 * np.pi * min(t, T_LOOP) / T_LOOP
    C = R_ORBIT * np.array([np.sin(theta), 0.0, np.cos(theta)], np.float32)
    C[1] = 0.08 * np.sin(1.3 * t)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.0, theta, 0.0], jnp.float32))).astype(np.float32)
    return C, R


def apply_drift_step(sys, after_frame_id, s=1.002, yaw=0.002,
                     dt=(0.004, -0.002, 0.002)):
    Rg = np.asarray(lie.so3_exp(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    tg = np.asarray(dt, np.float32)
    m = sys.m
    kf_sel = np.asarray(m.kf_active) & (np.asarray(m.kf_id) > after_frame_id)
    mp_sel = np.asarray(m.mp_active) & (np.asarray(m.mp_first_kf) > after_frame_id)
    P = np.array(m.kf_ns.P)
    R = np.array(m.kf_ns.R)
    P[kf_sel] = s * (P[kf_sel] @ Rg.T) + tg
    R[kf_sel] = np.einsum('ij,njk->nik', Rg, R[kf_sel])
    X = np.array(m.mp_pos)
    X[mp_sel] = s * (X[mp_sel] @ Rg.T) + tg
    sys.m = m._replace(kf_ns=m.kf_ns._replace(P=jnp.asarray(P), R=jnp.asarray(R)),
                       mp_pos=jnp.asarray(X))
    Pl, Rl = sys.last_pose
    sys.last_pose = (jnp.asarray(s * (np.asarray(Pl) @ Rg.T) + tg),
                     jnp.asarray(Rg @ np.asarray(Rl)))


@pytest.mark.slow
def test_loop_closure_heals_accumulated_drift(rng):
    from mc_slam.frontend import bow, extractor
    from mc_slam.pipeline import loopclosing

    world = CylinderWorld(rng)
    # ba_rtol: this scenario injects a NON-physical per-frame Sim3 warp into
    # the post-cutoff half of the map. A fully-converged window BA actively
    # fights each injection, mixing drift epochs and smearing the two halves'
    # relative geometry until no clean Sim3 relates them (loop Sim3 RANSAC
    # then finds ~2 inliers). Early-exit BA models the reference's
    # frequently-aborted background BA (mbAbortBA, src/LocalMapping.cpp:1112),
    # under which the injected warp stays locally coherent and closable.
    cfg = SlamConfig(max_kf=200, max_mp=4096, n_feat=384, n_levels=3,
                     min_init_matches=40, kf_min_gap=2, kf_max_gap=5,
                     ba_rtol=1e-4)
    sys = SlamSystem(CAM, cfg)
    # place recognition needs a vocabulary trained on this world's descriptor
    # statistics (like loading ORBvoc in the reference; a random vocab gives
    # flat ~0.9 scores on homogeneous synthetic texture)
    descs = []
    for th in np.linspace(0, 2 * np.pi, 8, endpoint=False):
        P, R = pose(th / (2 * np.pi) * T_LOOP)
        f = extractor.extract(jnp.asarray(world.render(R, P)),
                              n_features=384, n_levels=3)
        descs.append(np.asarray(f.desc_pm1)[np.asarray(f.valid)])
    d = jnp.asarray(np.concatenate(descs))
    vocab = bow.train_vocab(d, jnp.ones(d.shape[0]), jax.random.PRNGKey(7),
                            n_words=512, iters=3)
    sys.loop = loopclosing.LoopDetector(vocab, cfg.max_kf)

    n_frames, fdt = int((T_LOOP + 4.0) / 0.1), 0.1
    cutoff = None
    n_lost = 0
    for i in range(n_frames):
        t = i * fdt
        P, R = pose(t)
        ok = sys.track(world.render(R, P), t)
        n_lost += int(not ok and i > 2)
        # drift while the start region is out of view
        if sys.state == OK and 4.0 <= t <= T_LOOP - 4.0:
            if cutoff is None:
                cutoff = sys.frame_id - 1
            apply_drift_step(sys, cutoff)
    assert sys.state == OK
    assert n_lost < 10, f"{n_lost} lost frames"
    assert sys.n_loops_closed >= 1, "loop closure never fired"
    P_end = np.asarray(sys.last_pose[0])
    P_start = np.asarray(sys.m.kf_ns.P[0])
    gap = np.linalg.norm(P_end - P_start)
    # injected drift accumulates to ~0.55 map units; closure must reclaim most
    # of it (exact healing of a clean graph is covered by the pose-graph unit
    # test — this e2e is thread-nondeterministic on CPU, so the gate has slack)
    assert gap < 0.4, f"seam not healed: gap={gap}"
    assert bool(jnp.all(jnp.isfinite(sys.m.mp_pos)))
    # cross-seam covisibility: after SearchAndFuse (LoopClosing.cpp:732-764)
    # early-sequence KFs and late-sequence KFs must share landmarks — without
    # the fusion the two map halves keep duplicate points along the seam and
    # no BA can ever co-constrain them.
    from mc_slam.slam_map.mapstate import covisibility_matrix
    W = np.asarray(covisibility_matrix(sys.m))
    ids = np.asarray(sys.m.kf_id)
    act = np.asarray(sys.m.kf_active)
    early = act & (ids <= np.quantile(ids[act], 0.2))
    late = act & (ids >= np.quantile(ids[act], 0.8))
    seam_w = W[np.ix_(early, late)]
    assert seam_w.max() >= 10, f"no cross-seam covisibility (max={seam_w.max()})"
