"""The JAX matchers against the plain NumPy references (mc_slam.testing):
popcount Hamming and the brute-force projection search, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mc_slam import testing
from mc_slam.frontend import matching
from mc_slam.frontend.orb import unpack_pm1


def test_hamming_matrix_matches_popcount(rng):
    a = rng.integers(0, 2**32, (96, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    b[:96] = a                      # distance 0 on the diagonal
    b[96] = ~a[0]                   # distance 256
    got = np.asarray(matching.hamming_matrix(unpack_pm1(jnp.asarray(a)),
                                             unpack_pm1(jnp.asarray(b))))
    ref = testing.hamming_popcount(a, b)
    np.testing.assert_array_equal(got, ref)
    assert (np.diag(ref[:, :96]) == 0).all() and ref[0, 96] == 256


def _search(p, ratio, with_angles, device=None):
    akw = (dict(proj_angle=p["proj_angle"], feat_angle=p["feat_angle"],
                proj_angle_valid=p["proj_angle_valid"])
           if with_angles else {})
    put = (lambda x: jax.device_put(x, device)) if device else jnp.asarray
    got = matching.search_by_projection(
        put(p["proj_uv"]), put(p["proj_valid"]), put(p["proj_level"]),
        unpack_pm1(put(p["proj_desc"])), put(p["feat_uv"]),
        put(p["feat_level"]), unpack_pm1(put(p["feat_desc"])),
        put(p["feat_valid"]), radius_px=15.0, ratio=ratio,
        **{k: put(v) for k, v in akw.items()})
    ref = testing.search_by_projection(
        p["proj_uv"], p["proj_valid"], p["proj_level"], p["proj_desc"],
        p["feat_uv"], p["feat_level"], p["feat_desc"], p["feat_valid"],
        15.0, ratio=ratio, **akw)
    return [np.asarray(g) for g in got], ref


@pytest.mark.parametrize("with_angles", [False, True])
@pytest.mark.parametrize("ratio", [None, 0.9])
def test_search_by_projection_matches_numpy(rng, ratio, with_angles):
    p = testing.projection_problem(rng, 2048, 384)
    (idx, dist, ok), (idx_r, dist_r, ok_r) = _search(p, ratio, with_angles)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(idx, idx_r)
    np.testing.assert_array_equal(dist, dist_r)
    # the problem exercises every rule: matches survive, and the ratio test
    # and the rotation prune each remove some
    assert ok_r.sum() > 150
    if ratio is not None:
        assert ok_r.sum() < _search(p, None, with_angles)[1][2].sum()
    if with_angles:
        assert ok_r.sum() < _search(p, ratio, False)[1][2].sum()


@pytest.mark.gpu
def test_search_by_projection_on_gpu_matches_numpy(gpu_device):
    p = testing.projection_problem(np.random.default_rng(2), 16384, 1024)
    (idx, dist, ok), (idx_r, dist_r, ok_r) = _search(p, 0.9, True,
                                                     device=gpu_device)
    np.testing.assert_array_equal(ok, ok_r)
    np.testing.assert_array_equal(idx, idx_r)
    np.testing.assert_array_equal(dist, dist_r)
