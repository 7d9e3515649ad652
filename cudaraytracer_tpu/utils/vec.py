"""Vector math on trailing-dim-3 arrays.

Analog of the reference's device ``Vec3`` class
(reference: CudaRayTracer/src/Utils/Math.cuh:16-229).  Instead of a scalar
3-float struct per CUDA thread, every helper here operates on arrays shaped
``[..., 3]`` so an entire ray wavefront is processed per call.
All functions are pure and jit/vmap friendly.
"""

from __future__ import annotations

import jax.numpy as jnp

# Matches the reference's PI constant (Math.cuh:9).
PI = 3.14159265358979323846


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis: [..., 3] x [..., 3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return dot(v, v)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(v))


def normalize(v: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Unit vector (reference UnitVector, Math.cuh). rsqrt keeps it one elementwise op."""
    from jax import lax

    return v * lax.rsqrt(jnp.maximum(length_squared(v), eps))[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product over trailing axis (reference Cross, Math.cuh)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection (reference Reflect, Math.cuh:287-290)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: jnp.ndarray, n: jnp.ndarray, ni_over_nt: jnp.ndarray):
    """Snell refraction of unit vector ``uv`` about normal ``n``.

    Returns (can_refract[...], refracted[..., 3]).  Semantics follow the
    reference (Math.cuh:292-304): result only meaningful where can_refract.
    ``ni_over_nt`` broadcasts against the batch.
    """
    ni_over_nt = jnp.asarray(ni_over_nt)
    dt = dot(uv, n)
    discriminant = 1.0 - ni_over_nt**2 * (1.0 - dt**2)
    can = discriminant > 0.0
    safe_disc = jnp.maximum(discriminant, 0.0)
    refracted = (
        ni_over_nt[..., None] * (uv - n * dt[..., None])
        - n * jnp.sqrt(safe_disc)[..., None]
    )
    return can, refracted


def lerp(a: jnp.ndarray, b: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(1-t)*a + t*b with t broadcast over the vector axis."""
    t = jnp.asarray(t)[..., None]
    return (1.0 - t) * a + t * b


def clamp01(v: jnp.ndarray) -> jnp.ndarray:
    """Clamp components to [0, 1) range used before RGBA8 pack
    (reference Clamp, Math.cuh:307-315)."""
    return jnp.clip(v, 0.0, 0.999)
