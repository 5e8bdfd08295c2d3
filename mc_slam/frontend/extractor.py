"""Full ORB extraction: pyramid -> grid FAST -> orientation -> steered BRIEF.

Replaces ORBextractor::operator() (src/ORBextractor.cpp:1064-1130). Output is a
fixed-size padded keypoint table across all levels, with per-level feature
quotas proportional to inverse scale area (mnFeaturesPerLevel logic,
src/ORBextractor.cpp:211-231) and coordinates reported at level-0 resolution.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from mc_slam.frontend import fast, orb, pyramid


class Features(NamedTuple):
    xy: jnp.ndarray        # (N, 2) float32 keypoint positions, level-0 pixels (raw/distorted)
    level: jnp.ndarray     # (N,) int32 pyramid level
    angle: jnp.ndarray     # (N,) float32 rad
    score: jnp.ndarray     # (N,) float32 FAST response
    desc: jnp.ndarray      # (N, 8) uint32 packed 256-bit descriptors
    desc_pm1: jnp.ndarray  # (N, 256) int8 {-1,+1} (for GEMM matching)
    valid: jnp.ndarray     # (N,) bool


def per_level_quota(n_features, n_levels=8, scale=1.2):
    """Features per level ~ (1/scale)^i, normalized to sum to n_features."""
    inv = [(1.0 / scale) ** i for i in range(n_levels)]
    total = sum(inv)
    q = [int(round(n_features * v / total)) for v in inv]
    q[0] += n_features - sum(q)
    return q


@partial(jax.jit, static_argnames=("n_features", "n_levels", "cell"))
def extract(img, n_features=1024, n_levels=8, scale=1.2, th_hi=20.0, th_lo=7.0,
            cell=32) -> Features:
    """img: (H, W) grayscale in [0,255] — float32, or uint8 (cast on device:
    u8 frames cost 4x less host->device bandwidth). Returns padded Features of
    exactly n_features rows (invalid rows masked)."""
    img = img.astype(jnp.float32)
    levels = pyramid.build_pyramid(img, n_levels, scale)
    quotas = per_level_quota(n_features, n_levels, scale)
    sf = pyramid.scale_factors(n_levels, scale)

    # per-level detection + patch extraction; orientation and descriptors run
    # ONCE over the concatenated patches of all levels (matmul formulation).
    # Two patch sets, as the reference: IC angle on the RAW level image
    # (ORBextractor.cpp computeOrientation), BRIEF on the blurred one.
    # (Sharing the blurred set for both was tried — it halves the dominant
    # patch-gather cost — but measurably degrades angle stability and broke
    # the post-reloc bias-window e2e; reverted.)
    xys, lvls, scores, valids, patches_raw, patches_blur = [], [], [], [], [], []
    for li, (lvl_img, quota) in enumerate(zip(levels, quotas)):
        if quota == 0:
            continue
        xy, score, valid = fast.detect_grid(lvl_img, th_hi, th_lo, cell=cell,
                                            max_kp=quota, border=16)
        blur = pyramid.gaussian_blur(lvl_img)
        patches_raw.append(orb.extract_patches(lvl_img, xy))
        patches_blur.append(orb.extract_patches(blur, xy))
        xys.append(xy.astype(jnp.float32) * sf[li])
        lvls.append(jnp.full((quota,), li, jnp.int32))
        scores.append(score)
        valids.append(valid)

    xy = jnp.concatenate(xys)
    level = jnp.concatenate(lvls)
    score = jnp.concatenate(scores)
    valid = jnp.concatenate(valids)
    p_raw = jnp.concatenate(patches_raw)
    p_blur = jnp.concatenate(patches_blur)
    angle = orb.ic_angle_from_patches(p_raw)
    bits = orb.brief_from_patches(p_blur, angle)
    bits = bits * valid[:, None].astype(bits.dtype)
    desc = orb.pack_bits(bits)
    return Features(xy=xy, level=level, angle=angle, score=score, desc=desc,
                    desc_pm1=orb.bits_to_pm1(bits), valid=valid)
