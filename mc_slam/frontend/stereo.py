"""Stereo depth from rectified left/right feature matching.

Replaces Frame::ComputeStereoMatches (the reference inherits ORB-SLAM2's
row-banded stereo matcher; stereo L/R extraction threads, src/Frame.cpp:259-260):
left features match right features within an epipolar row band and a disparity
range, by Hamming distance as one GEMM; depth = fx * baseline / disparity.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mc_slam.frontend import matching


@jax.jit
def stereo_depth(uvL, pm1L, validL, uvR, pm1R, validR, fx, baseline,
                 row_tol=2.0, max_disp=128.0, min_disp=0.5,
                 max_dist=matching.TH_HIGH):
    """Per-left-feature depth from rectified stereo matching.

    uvL/uvR: (N,2)/(M,2) undistorted pixels; pm1*: descriptors; returns
    (depth (N,), ok (N,) bool) with depth = fx*b/disparity for matched features.
    """
    dist = matching.hamming_matrix(pm1L, pm1R)
    dv = jnp.abs(uvL[:, None, 1] - uvR[None, :, 1])
    disp = uvL[:, None, 0] - uvR[None, :, 0]      # positive for valid stereo
    gate = (dv <= row_tol) & (disp >= min_disp) & (disp <= max_disp)
    gate = gate & validL[:, None] & validR[None, :]
    idx, best, ok = matching.match_nn(dist, gate, max_dist=max_dist, ratio=0.9)
    # mutual (left-right) consistency kills wrong-row matches, whose bogus
    # disparities would otherwise seed gross-outlier landmarks
    d_masked = jnp.where(gate, dist, matching.BIG)
    idx_rl = jnp.argmin(d_masked.T, axis=1)
    mutual = idx_rl[idx] == jnp.arange(uvL.shape[0])
    ok = ok & mutual
    d = uvL[:, 0] - uvR[idx, 0]
    depth = fx * baseline / jnp.maximum(d, 1e-6)
    return jnp.where(ok, depth, -1.0), ok
