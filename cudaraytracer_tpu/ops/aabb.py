"""AABB slab test, vectorized over rays.

Analog of the reference AABB::Hit (reference:
CudaRayTracer/src/Hittables/AABB.cuh:30-50): per-axis interval clipping with
inverse-direction multiply.  Here all three axes and all rays are processed
at once, and the caller precomputes inv_dir once per bounce
instead of once per node visit.
"""

from __future__ import annotations

import jax.numpy as jnp


def inv_direction(dirn: jnp.ndarray) -> jnp.ndarray:
    """1/d with sign-preserving infinities for zero components."""
    return jnp.where(dirn == 0.0, jnp.float32(1e30), 1.0 / dirn)


def aabb_hit(
    org: jnp.ndarray,  # f32[R,3]
    inv_dir: jnp.ndarray,  # f32[R,3]
    bmin: jnp.ndarray,  # f32[R,3] (or broadcastable)
    bmax: jnp.ndarray,  # f32[R,3]
    t_min,
    t_max,  # f32[R] current closest-hit budget
) -> jnp.ndarray:
    """bool[R]: does the ray intersect the box within (t_min, t_max)?"""
    t0 = (bmin - org) * inv_dir  # [R,3]
    t1 = (bmax - org) * inv_dir
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(near, axis=-1), t_min)
    exit_ = jnp.minimum(jnp.min(far, axis=-1), t_max)
    return exit_ > enter


def surrounding_box(min_a, max_a, min_b, max_b):
    """Union of two AABBs (reference SurroundingBox, AABB.cuh:53-62)."""
    return jnp.minimum(min_a, min_b), jnp.maximum(max_a, max_b)
