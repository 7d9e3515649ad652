"""Material scatter/emission over a ray batch.

Analog of the reference's Material tagged union with
Lambertian/Metal/Dielectric/DiffuseLight variants (reference:
CudaRayTracer/src/Hittables/Material.cuh:34-177) and the per-bounce type
switch in the radiance loop (CudaRayTracer/src/Cuda/Kernel.cu:51-72).

All four material branches are computed for every lane and combined with
masked selects — on a vector machine this costs less than divergent control
flow would, since each branch is a few elementwise ops.  RNG is counter-based
(one shared in-unit-sphere draw and one uniform draw per bounce) instead of
curand state arrays.

Material type encoding (MaterialType enum order, Material.cuh:6-12; type 4
is BEYOND-REFERENCE):
    0 = lambertian, 1 = metal, 2 = dielectric, 3 = diffuse light,
    4 = isotropic (constant-density participating medium — the RTOW book-2
        ConstantMedium phase function: scatter in a uniform random
        direction, attenuate by the medium's texture color; the medium
        DISTANCE sampling lives in the intersection layer, ops/intersect.py)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils.vec import dot, length, normalize, reflect, refract

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
ISOTROPIC = 4


class ScatterResult(NamedTuple):
    direction: jnp.ndarray  # f32[R,3] scattered ray direction (NOT normalized,
    #                         matching the reference's unnormalized scatter rays)
    attenuation: jnp.ndarray  # f32[R,3]
    scattered: jnp.ndarray  # bool[R] True if the path continues
    emitted: jnp.ndarray  # f32[R,3] radiance emitted at this hit (lights)


def _schlick(cosine: jnp.ndarray, ir: jnp.ndarray) -> jnp.ndarray:
    """Schlick reflectance (Material.cuh:139-145)."""
    r0 = (1.0 - ir) / (1.0 + ir)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(
    ray_dir: jnp.ndarray,  # f32[R,3] incoming ray direction
    point: jnp.ndarray,  # f32[R,3] hit point (unused; kept for parity/clarity)
    normal: jnp.ndarray,  # f32[R,3] geometric normal (sphere: raw outward)
    mat_type: jnp.ndarray,  # i32[R]
    fuzz: jnp.ndarray,  # f32[R]
    ior: jnp.ndarray,  # f32[R] index of refraction
    light: jnp.ndarray,  # f32[R] light intensity
    tex_color: jnp.ndarray,  # f32[R,3] albedo sampled from the hit's texture
    sphere_sample: jnp.ndarray,  # f32[R,3] uniform point in the unit ball
    uniform_sample: jnp.ndarray,  # f32[R] uniform in [0,1)
) -> ScatterResult:
    # ---- lambertian (Material.cuh:44-62): dir = normal + in_unit_sphere ----
    lamb_dir = normal + sphere_sample

    # ---- metal (Material.cuh:77-94): reflect(unit(d), n) + fuzz*s;
    #      absorbed if the fuzzed ray dips below the surface ----
    reflected_unit = reflect(normalize(ray_dir), normal)
    metal_dir = reflected_unit + fuzz[:, None] * sphere_sample
    metal_ok = dot(metal_dir, normal) > 0.0

    # ---- dielectric (Material.cuh:104-136): exact reference semantics,
    #      including the unnormalized-direction cosine and Schlick blend ----
    d_dot_n = dot(ray_dir, normal)
    d_len = length(ray_dir)
    exiting = d_dot_n > 0.0
    outward = jnp.where(exiting[:, None], -normal, normal)
    ni_over_nt = jnp.where(exiting, ior, 1.0 / ior)
    cos_in = d_dot_n / d_len
    cos_exit = jnp.sqrt(
        jnp.maximum(0.0, 1.0 - ior * ior * (1.0 - cos_in * cos_in))
    )
    cosine = jnp.where(exiting, cos_exit, -cos_in)
    can_refract, refracted = refract(normalize(ray_dir), outward, ni_over_nt)
    reflect_prob = jnp.where(can_refract, _schlick(cosine, ior), 1.0)
    # reference reflects the raw (unnormalized) direction here (Material.cuh:106)
    reflected_raw = reflect(ray_dir, normal)
    diel_dir = jnp.where(
        (uniform_sample < reflect_prob)[:, None], reflected_raw, refracted
    )

    # ---- diffuse light (Material.cuh:158-176): no scatter, emits I * tex ----
    emitted_light = light[:, None] * tex_color

    is_lamb = (mat_type == LAMBERTIAN)[:, None]
    is_metal = (mat_type == METAL)[:, None]
    is_diel = (mat_type == DIELECTRIC)[:, None]
    is_light = mat_type == DIFFUSE_LIGHT

    is_iso = (mat_type == ISOTROPIC)[:, None]

    direction = jnp.where(is_lamb, lamb_dir, jnp.zeros_like(lamb_dir))
    direction = jnp.where(is_metal, metal_dir, direction)
    direction = jnp.where(is_diel, diel_dir, direction)
    # isotropic phase function: uniform random direction (the in-unit-ball
    # sample IS the RTOW Isotropic::Scatter direction, Ray(p, rand_in_sphere))
    direction = jnp.where(is_iso, sphere_sample, direction)

    ones = jnp.ones_like(tex_color)
    attenuation = jnp.where(is_diel, ones, tex_color)

    scattered = (mat_type == LAMBERTIAN) | (mat_type == DIELECTRIC)
    scattered = scattered | ((mat_type == METAL) & metal_ok)
    scattered = scattered | (mat_type == ISOTROPIC)

    emitted = jnp.where(is_light[:, None], emitted_light, jnp.zeros_like(tex_color))

    return ScatterResult(
        direction=direction,
        attenuation=attenuation,
        scattered=scattered,
        emitted=emitted,
    )
