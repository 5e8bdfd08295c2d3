"""Oriented BRIEF descriptors: IC-angle orientation + steered binary tests.

Replaces IC_Angle (src/ORBextractor.cpp:79) and computeOrbDescriptor (:111).
The 256 sampling pairs are a deterministic generated Gaussian pattern (NOT the
OpenCV bit_pattern_31_ table — descriptors here only ever match against
descriptors from this same extractor, so a fresh pattern with the same
statistics is equivalent and keeps this implementation fully from-scratch).

Batched formulation (no per-element gathers; everything is a slice or a
matmul):
  * per-keypoint 31x31 patches come from ONE batched dynamic_slice (fast:
    contiguous rows);
  * IC angle = patches_flat @ moment_weights  (961 x 2 matmul);
  * steered BRIEF quantizes the rotation into NBINS=32 steps (11.25 deg, finer
    than BRIEF's own noise floor) and samples ALL bins at once with a selection
    matmul patches_flat @ S^T where S is the precomputed (NBINS*256, 961)
    one-hot table for each pattern point — then picks each keypoint's bin row.

Descriptors are packed 256-bit words as (N, 8) uint32 plus the +/-1 int8 form
(N, 256) used by the Hamming GEMM matcher (matching.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

PATCH_R = 15          # patch radius (31x31), as the reference
PATCH_W = 2 * PATCH_R + 1
BRIEF_R = 13          # max test-point radius so rotated points stay in-patch
NBINS = 32            # rotation quantization for the steered pattern


def _make_pattern(seed=42, n=256, sigma=5.2, rmax=BRIEF_R):
    """(n, 4) pattern [x1, y1, x2, y2], Gaussian-distributed, clipped."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n, 4))
    pts = np.clip(np.round(pts), -rmax, rmax)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] = np.clip(pts[same, 2] + 1, -rmax, rmax)
    return pts.astype(np.float32)


PATTERN = _make_pattern()                     # (256, 4) numpy


def _selection_tables():
    """Precompute per-bin rotated nearest-integer sample indices as one-hot
    selection matrices: (NBINS*256, 961) for each of the two pattern points."""
    S1 = np.zeros((NBINS * 256, PATCH_W * PATCH_W), np.float32)
    S2 = np.zeros_like(S1)
    for b in range(NBINS):
        th = 2.0 * np.pi * b / NBINS
        ca, sa = np.cos(th), np.sin(th)
        for s in range(256):
            x1, y1, x2, y2 = PATTERN[s]
            for (x, y, S) in ((x1, y1, S1), (x2, y2, S2)):
                rx = int(np.clip(np.round(ca * x - sa * y), -PATCH_R, PATCH_R))
                ry = int(np.clip(np.round(sa * x + ca * y), -PATCH_R, PATCH_R))
                S[b * 256 + s, (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)] = 1.0
    return S1, S2


_S1_np, _S2_np = _selection_tables()
# NOTE: these tables stay HOST (numpy) arrays on purpose. As device arrays
# they are embedded into every jit that closes over them by PULLING their
# value to the host during lowering; numpy constants embed host-side with no
# transfer.
S1 = _S1_np                                   # (NBINS*256, 961)
S2 = _S2_np
# difference table: bit s in bin b is sign(I[S2 row] - I[S1 row]); entries in
# {-1, 0, +1} (0 when a pair rotates onto the same pixel -> bit fixed to 0,
# same semantics as comparing identical samples)
D_TABLE = _S2_np - _S1_np                     # (NBINS*256, 961)

# circular-patch mask + moment weights for IC angle (u_max table equivalent)
_d = np.arange(-PATCH_R, PATCH_R + 1)
_mask = (_d[None, :] ** 2 + _d[:, None] ** 2) <= PATCH_R * PATCH_R
_MW = np.stack([
    (_mask * _d[None, :]).reshape(-1),        # m10 weights (x)
    (_mask * _d[:, None]).reshape(-1),        # m01 weights (y)
], axis=1).astype(np.float32)
MOMENT_W = _MW                                # (961, 2) — host, see above


def extract_patches(img, xy, r=PATCH_R):
    """(K, 2r+1, 2r+1) patches via batched dynamic_slice (contiguous rows —
    fast, unlike per-element gathers). Border keypoints clamp the
    window (detection borders already exceed r)."""
    H, W = img.shape
    xi = jnp.round(xy).astype(jnp.int32) if jnp.issubdtype(xy.dtype, jnp.floating) else xy
    y0 = jnp.clip(xi[:, 1] - r, 0, H - (2 * r + 1))
    x0 = jnp.clip(xi[:, 0] - r, 0, W - (2 * r + 1))
    return jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(img, (y, x), (2 * r + 1, 2 * r + 1))
    )(y0, x0)


def ic_angle_from_patches(patches):
    """(K, 31, 31) -> (K,) IC angle: one (K,961)@(961,2) matmul."""
    m = patches.reshape(patches.shape[0], -1) @ MOMENT_W
    return jnp.arctan2(m[:, 1], m[:, 0])


def ic_angle(img, xy):
    """Compatibility wrapper: gather patches then matmul."""
    return ic_angle_from_patches(extract_patches(img, xy))


def brief_from_patches(patches_blur, angle):
    """Steered BRIEF from blurred patches.

    patches_blur: (K, 31, 31); angle: (K,) rad.
    Returns (bits (K,256) uint32 {0,1}).
    """
    K = patches_blur.shape[0]
    flat = patches_blur.reshape(K, -1)                         # (K, 961)
    # All-bin BRIEF in one matmul against the DIFFERENCE table D = S2 - S1
    # (each bit only needs sign(I2 - I1), so the two one-hot sample tables
    # collapse into one {-1,0,+1} table — half the FLOPs of sampling I1 and
    # I2 separately). Run it in bf16 without losing the sub-gray signal via
    # a hi/lo split: hi = round(flat) is integer grays 0..255 (EXACT in
    # bf16's 8-bit significand, D entries likewise exact), lo = flat - hi is
    # <= 0.5 in magnitude so its bf16 rounding error is <= 2^-9 ~ 0.001 gray.
    # Total error vs the f32 matmul is ~0.002 gray per bit decision — far
    # below the blur's own discretization — while the matmul runs at the
    # native bf16 rate.
    # (Plain bf16-casting the un-rounded blur output costs up to 0.5 gray
    # and measurably destabilized matching: post-reloc bias-window e2e.)
    hi = jnp.round(flat)
    lo = (flat - hi).astype(jnp.bfloat16)
    Dt = D_TABLE.T.astype(jnp.bfloat16)                        # (961, NBINS*256)
    d = (jax.lax.dot(hi.astype(jnp.bfloat16), Dt,
                     preferred_element_type=jnp.float32)
         + jax.lax.dot(lo, Dt,
                       preferred_element_type=jnp.float32)).reshape(K, NBINS, 256)
    two_pi = 2.0 * jnp.pi
    b = jnp.round(jnp.mod(angle, two_pi) * (NBINS / two_pi)).astype(jnp.int32) % NBINS
    onehot = jax.nn.one_hot(b, NBINS, dtype=flat.dtype)        # (K, NBINS)
    diff = jnp.einsum('kbs,kb->ks', d, onehot)
    return (diff > 0).astype(jnp.uint32)


def pack_bits(bits):
    """(K, 256) {0,1} -> (K, 8) uint32 packed words."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(bits.reshape(-1, 8, 32) << shifts[None, None, :],
                   axis=-1).astype(jnp.uint32)


def bits_to_pm1(bits):
    """(K, 256) {0,1} -> (K, 256) int8 {-1,+1}."""
    return (bits.astype(jnp.int8) * 2 - 1)


def brief_descriptors(img_blur, xy, angle):
    """Compatibility wrapper: packed (K, 8) uint32 descriptors."""
    return pack_bits(brief_from_patches(extract_patches(img_blur, xy), angle))


def unpack_pm1(desc_packed):
    """(N, 8) uint32 -> (N, 256) int8 in {-1, +1} for Hamming GEMMs."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc_packed[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    b = bits.reshape(desc_packed.shape[0], 256).astype(jnp.int8)
    return b * 2 - 1
