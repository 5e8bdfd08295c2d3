"""Front-end tests: FAST corner detection on synthetic patterns, descriptor
invariance under rotation, matching across a shifted/rotated view pair."""
import jax
import jax.numpy as jnp
import numpy as np

from mc_slam.frontend import extractor, fast, matching, orb, pyramid


def checkerboard(h=240, w=320, sq=24, lo=40.0, hi=200.0):
    y, x = np.mgrid[0:h, 0:w]
    img = np.where(((y // sq) + (x // sq)) % 2 == 0, hi, lo)
    return img.astype(np.float32)


def blob_image(rng, h=240, w=320, n=60):
    """Random bright square blobs on dark background — strong unambiguous corners."""
    img = np.full((h, w), 30.0, np.float32)
    for _ in range(n):
        cy, cx = rng.integers(20, h - 20), rng.integers(20, w - 20)
        s = rng.integers(4, 9)
        img[cy - s:cy + s, cx - s:cx + s] = rng.uniform(120, 250)
    return img


class TestFAST:
    def test_detects_square_corners(self):
        """L-corners of a bright square give contiguous arcs of ~12 — the
        canonical FAST-positive. (A perfect checkerboard X-crossing is a known
        FAST-negative: arcs of ~8 < 9.)"""
        img = np.full((60, 60), 30.0, np.float32)
        img[20:40, 20:40] = 200.0
        mask, score = fast.fast_response(jnp.asarray(img), 20.0)
        ys, xs = np.nonzero(np.asarray(mask))
        assert len(ys) >= 4
        corners = np.asarray([[20, 20], [39, 20], [20, 39], [39, 39]])
        for c in corners:
            d = np.abs(np.stack([xs, ys], 1) - c).max(axis=1)
            assert d.min() <= 2, c
        # all detections near some corner, none on edges/flat regions
        d_all = np.min(np.abs(xs[:, None] - corners[None, :, 0])
                       + np.abs(ys[:, None] - corners[None, :, 1]), axis=1)
        assert d_all.max() <= 5

    def test_nms_thins_detections(self):
        img = np.full((60, 60), 30.0, np.float32)
        img[20:40, 20:40] = 200.0
        _, score = fast.fast_response(jnp.asarray(img), 20.0)
        keep = np.asarray(fast.nms3(score))
        assert 0 < keep.sum() <= 8

    def test_flat_image_no_corners(self):
        img = jnp.full((120, 160), 100.0)
        mask, _ = fast.fast_response(img, 7.0)
        assert int(jnp.sum(mask)) == 0

    def test_grid_detection_spread(self, rng):
        img = jnp.asarray(blob_image(rng))
        xy, score, valid = fast.detect_grid(img, max_kp=256, cell=24)
        n = int(valid.sum())
        assert n > 40
        pts = np.asarray(xy)[np.asarray(valid)]
        # spatial spread: occupied cells of a 6x8 coarse grid
        occ = {(int(p[0]) // 54, int(p[1]) // 40) for p in pts}
        assert len(occ) > 10


class TestORB:
    def test_angle_rotation_equivariance(self, rng):
        """Rotating the patch rotates the IC angle accordingly."""
        img = blob_image(rng)
        J = jnp.asarray(img)
        xy, score, valid = fast.detect_grid(J, max_kp=64, cell=24)
        ang = orb.ic_angle(J, xy)
        # rotate image 90deg CW: (x,y) -> (W-1-y... ) use np.rot90 and map points
        img90 = np.ascontiguousarray(np.rot90(img, k=-1))  # CW
        H, W = img.shape
        xy_np = np.asarray(xy)
        xy90 = np.stack([H - 1 - xy_np[:, 1], xy_np[:, 0]], 1)
        ang90 = orb.ic_angle(jnp.asarray(img90), jnp.asarray(xy90, jnp.int32))
        v = np.asarray(valid) & (np.asarray(score) > 50)
        d = np.mod(np.asarray(ang90) - np.asarray(ang) - np.pi / 2 + np.pi, 2 * np.pi) - np.pi
        assert np.median(np.abs(d[v])) < 0.15

    def test_descriptor_determinism_and_packing(self, rng):
        img = jnp.asarray(blob_image(rng))
        xy, _, valid = fast.detect_grid(img, max_kp=64, cell=24)
        blur = pyramid.gaussian_blur(img)
        ang = orb.ic_angle(img, xy)
        d1 = orb.brief_descriptors(blur, xy, ang)
        d2 = orb.brief_descriptors(blur, xy, ang)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        pm1 = orb.unpack_pm1(d1)
        assert pm1.shape == (64, 256)
        assert set(np.unique(np.asarray(pm1))) <= {-1, 1}

    def test_hamming_consistency(self, rng):
        img = jnp.asarray(blob_image(rng))
        xy, _, _ = fast.detect_grid(img, max_kp=32, cell=32)
        blur = pyramid.gaussian_blur(img)
        d = orb.brief_descriptors(blur, xy, orb.ic_angle(img, xy))
        pm1 = orb.unpack_pm1(d)
        hm_gemm = matching.hamming_matrix(pm1, pm1)
        hm_pop = matching.hamming_matrix_popcount(d, d)
        np.testing.assert_array_equal(np.asarray(hm_gemm), np.asarray(hm_pop))
        assert np.all(np.diag(np.asarray(hm_gemm)) == 0)


class TestExtractAndMatch:
    def test_extract_full(self, rng):
        img = jnp.asarray(blob_image(rng, h=480, w=640, n=150))
        f = extractor.extract(img, n_features=512)
        assert f.xy.shape == (512, 2)
        n = int(f.valid.sum())
        assert n > 200
        assert int(f.level.max()) >= 1  # multi-level detections exist

    def test_match_shifted_view(self, rng):
        """Two views of the same texture, shifted by (8, 5) px: matches must
        recover the shift."""
        base = blob_image(rng, h=300, w=400, n=120)
        dx, dy = 8, 5
        img0 = jnp.asarray(base[10:260, 10:360])
        img1 = jnp.asarray(base[10 + dy:260 + dy, 10 + dx:360 + dx])
        f0 = extractor.extract(img0, n_features=384, n_levels=4)
        f1 = extractor.extract(img1, n_features=384, n_levels=4)
        idx, best, ok = matching.search_for_initialization(
            f0.xy, f0.desc_pm1, f0.valid, f1.xy, f1.desc_pm1, f1.valid,
            radius=40.0)
        ok = np.asarray(ok)
        assert ok.sum() > 40
        d = np.asarray(f0.xy)[ok] - np.asarray(f1.xy)[np.asarray(idx)[ok]]
        med = np.median(d, axis=0)
        np.testing.assert_allclose(med, [dx, dy], atol=1.5)
        # rotation consistency filter keeps most of these (pure translation)
        ok2 = matching.rotation_consistency_mask(
            f0.angle, f1.angle, jnp.asarray(idx), jnp.asarray(ok))
        assert np.asarray(ok2).sum() > 0.6 * ok.sum()


class TestRotationConsistencyWired:
    """VERDICT round-1 item 7: the 30-bin rotation-histogram filter must FIRE
    inside the search paths (the reference applies it in every major search,
    src/ORBmatcher.cpp:325-332), not just exist as a tested helper."""

    def test_search_by_projection_drops_rotation_outliers(self, rng):
        N = 64
        # identical descriptor per pair => unambiguous identity matching
        desc = rng.integers(0, 2, size=(N, 256)).astype(np.int8)
        pm1 = jnp.asarray(2 * desc - 1, jnp.int8)
        uv = jnp.asarray(rng.uniform(50, 250, size=(N, 2)), jnp.float32)
        lvl = jnp.zeros(N, jnp.int32)
        valid = jnp.ones(N, bool)
        # consistent relative rotation for most; 4 wild outliers (<10% of the
        # dominant bin -> the reference's 0.1*max1 cutoff drops their bin)
        ang_map = jnp.full((N,), 0.5, jnp.float32)
        ang_feat = np.full(N, 0.2, np.float32)
        out_idx = np.arange(4)
        ang_feat[out_idx] = 2.8  # ~2.6 rad relative offset -> different bin
        idx, best, ok = matching.search_by_projection(
            uv, valid, lvl, pm1, uv, lvl, pm1, valid, radius_px=9.0,
            proj_angle=ang_map, feat_angle=jnp.asarray(ang_feat))
        ok = np.asarray(ok)
        assert ok[4:].sum() >= 0.9 * (N - 4)       # inliers survive
        assert ok[out_idx].sum() == 0               # outliers dropped
        # without angles the same outliers would pass (filter genuinely fired)
        _, _, ok_noang = matching.search_by_projection(
            uv, valid, lvl, pm1, uv, lvl, pm1, valid, radius_px=9.0)
        assert np.asarray(ok_noang)[out_idx].sum() == 4
