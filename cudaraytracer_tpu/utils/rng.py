"""Counter-based sampling primitives.

Replaces the reference's stateful curand machinery (per-pixel ``curandState``
arrays seeded in RenderInit, reference: CudaRayTracer/src/Cuda/Kernel.cu:160-176,
and the rejection-sampling helpers RandomInUnitSphere / RandomInUnitDisk,
reference: CudaRayTracer/src/Utils/Math.cuh:252-285).

Design decisions:
  * No RNG state arrays: keys are derived on the fly with
    ``jax.random.fold_in(base, counter)`` per (frame, bounce, purpose) so a
    viewport resize never needs a re-seed pass and results are reproducible.
  * No rejection loops (data-dependent trip counts don't vectorize): unit-sphere
    and unit-disk points are drawn with exact closed-form inverse-CDF sampling,
    which has identical distribution and fixed cost per lane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .vec import PI

# Reference seeds curand with 1984 (Kernel.cu:163,175); we keep the same
# default seed for spiritual parity.
DEFAULT_SEED = 1984


def base_key(seed: int = DEFAULT_SEED) -> jax.Array:
    return jax.random.PRNGKey(seed)


def frame_key(key: jax.Array, frame: jnp.ndarray | int) -> jax.Array:
    """Key for one progressive frame (sample index)."""
    return jax.random.fold_in(key, frame)


def bounce_key(fkey: jax.Array, bounce: jnp.ndarray | int) -> jax.Array:
    """Key for one bounce within a frame."""
    return jax.random.fold_in(fkey, bounce)


def uniform3(key: jax.Array, shape) -> jnp.ndarray:
    """[..., 3] uniform in [0,1) (reference Random(rand_state), Math.cuh:231-234)."""
    return jax.random.uniform(key, tuple(shape) + (3,))


def unit_vector(key: jax.Array, shape) -> jnp.ndarray:
    """Uniform direction on the unit sphere, closed form (no rejection)."""
    u = jax.random.uniform(key, tuple(shape) + (2,))
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_unit_sphere(key: jax.Array, shape) -> jnp.ndarray:
    """Uniform point inside the unit ball.

    Equal in distribution to the reference's rejection sampler
    (Math.cuh:252-260) but with fixed cost: direction uniform on the sphere,
    radius r = cbrt(u) so volume is uniform.
    """
    kd, kr = jax.random.split(key)
    d = unit_vector(kd, shape)
    r = jnp.cbrt(jax.random.uniform(kr, tuple(shape)))
    return d * r[..., None]


def in_unit_hemisphere(key: jax.Array, normal: jnp.ndarray) -> jnp.ndarray:
    """Uniform point in the hemisphere around ``normal`` (Math.cuh:262-270)."""
    from .vec import dot

    p = in_unit_sphere(key, normal.shape[:-1])
    same = dot(p, normal) > 0.0
    return jnp.where(same[..., None], p, -p)


def in_unit_disk(key: jax.Array, shape) -> jnp.ndarray:
    """Uniform point in the unit disk (z=0), closed form (Math.cuh:272-285).

    Used for defocus-blur aperture sampling.
    """
    u = jax.random.uniform(key, tuple(shape) + (2,))
    r = jnp.sqrt(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return jnp.stack(
        [r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1
    )
