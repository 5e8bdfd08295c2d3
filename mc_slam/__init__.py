"""mc_slam: visual-inertial SLAM engine as fixed-shape JAX device programs.

A from-scratch reimplementation of the capabilities of mc275/MC_SLAM
(ORB-SLAM2 + on-manifold IMU preintegration + VI-ORB initialization) as batched,
fixed-shape device programs. See SURVEY.md for the reference analysis and the
layer-by-layer parity map.
"""

import jax as _jax

# SLAM estimation (Lie math, LM normal equations, Schur complements) needs true
# float32 matmuls. A lower default precision (TF32 on NVIDIA tensor cores, about
# three decimal digits) breaks rotation orthonormality at the 1e-2 level.
# Correctness is the default; the few throughput kernels that tolerate less
# (Hamming matching runs in int8 anyway, image filtering) opt back in locally
# with precision= / preferred_element_type=.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
