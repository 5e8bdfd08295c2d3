"""Image pyramid + Gaussian blur.

Replaces ORBextractor::ComputePyramid (src/ORBextractor.cpp:1134) and the
pre-descriptor GaussianBlur (src/ORBextractor.cpp:1105): 8 levels, scale 1.2,
bilinear downsampling, 7x7 sigma-2 Gaussian as separable depthwise convs.
Shapes are static per level (computed at trace time), so the whole pyramid jits.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

DEFAULT_LEVELS = 8
DEFAULT_SCALE = 1.2


def level_shapes(h, w, n_levels=DEFAULT_LEVELS, scale=DEFAULT_SCALE):
    return [(int(round(h / scale**i)), int(round(w / scale**i))) for i in range(n_levels)]


def scale_factors(n_levels=DEFAULT_LEVELS, scale=DEFAULT_SCALE):
    return [scale**i for i in range(n_levels)]


def build_pyramid(img, n_levels=DEFAULT_LEVELS, scale=DEFAULT_SCALE):
    """img: (H, W) float32 in [0, 255]. Returns list of (Hi, Wi) arrays."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for i in range(1, n_levels):
        # resize from the previous level (matches the reference's incremental resize)
        levels.append(jax.image.resize(levels[-1], shapes[i], method="bilinear"))
    return levels


def _gauss_kernel1d(sigma=2.0, radius=3, dtype=jnp.float32):
    x = jnp.arange(-radius, radius + 1, dtype=dtype)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


@partial(jax.jit, static_argnames=("radius",))
def gaussian_blur(img, sigma=2.0, radius=3):
    """Separable 7x7 Gaussian with reflect padding; img (H, W) float32.

    Implemented as shifted elementwise adds that XLA fuses into one pass,
    NOT lax.conv: a single-channel 7-tap conv leaves matrix hardware idle."""
    k = _gauss_kernel1d(sigma, radius, img.dtype)
    H, W = img.shape
    x = jnp.pad(img, ((radius, radius), (0, 0)), mode="reflect")
    out = jnp.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * jax.lax.slice(x, (i, 0), (i + H, W))
    x = jnp.pad(out, ((0, 0), (radius, radius)), mode="reflect")
    out = jnp.zeros_like(img)
    for i in range(2 * radius + 1):
        out = out + k[i] * jax.lax.slice(x, (0, i), (H, i + W))
    return out
