"""Texture evaluation over a ray batch.

Analog of the reference's Texture tagged union with
Constant/Checker/Image variants (reference:
CudaRayTracer/src/Hittables/Texture.cuh:7-109).  Instead of pointer-union
dispatch per CUDA thread, textures are SoA fields of the primitive table and
all three variants are evaluated branch-free with masked selects (they are
each a handful of elementwise ops); image lookups gather from a fixed-capacity
uint8 texture atlas resident on device.

Texture type encoding (TextureType enum order, Texture.cuh:7-12; type 3 is
BEYOND-REFERENCE):
    0 = constant   (albedo)
    1 = checker    (albedo = odd color, albedo2 = even color)
    2 = image      (tex_id selects an atlas slot; albedo used as fallback)
    3 = noise      (RTOW "The Next Week" marble, ops/noise.py:
                    lerp(albedo2, albedo, marble_factor); tex_id is
                    REPURPOSED as the integer marble scale, max(tex_id, 1) —
                    noise needs no atlas slot, so the field is free)
"""

from __future__ import annotations

import jax.numpy as jnp

from .noise import marble_factor

CONSTANT = 0
CHECKER = 1
IMAGE = 2
NOISE = 3

# Reference returns cyan when an image texture has no data (Texture.cuh:88-89).
_MISSING_IMAGE_COLOR = (0.0, 1.0, 1.0)


def sample_texture(
    tex_type: jnp.ndarray,  # i32[R] (already gathered per-ray)
    albedo: jnp.ndarray,  # f32[R,3] constant color / checker odd color
    albedo2: jnp.ndarray,  # f32[R,3] checker even color
    tex_id: jnp.ndarray,  # i32[R] atlas slot, -1 = no image data
    u: jnp.ndarray,  # f32[R]
    v: jnp.ndarray,  # f32[R]
    p: jnp.ndarray,  # f32[R,3] hit point (checker is solid/3D)
    atlas: jnp.ndarray,  # uint8[S,AH,AW,3] image atlas
    tex_hw: jnp.ndarray,  # i32[S,2] valid (height,width) per slot
) -> jnp.ndarray:
    """Albedo color for each ray's hit, f32[R,3]."""
    # --- checker (Texture.cuh:58-67): sin(10x)sin(10y)sin(10z) sign picks odd/even
    sines = jnp.sin(10.0 * p[:, 0]) * jnp.sin(10.0 * p[:, 1]) * jnp.sin(10.0 * p[:, 2])
    checker = jnp.where((sines < 0.0)[:, None], albedo, albedo2)

    # --- image (Texture.cuh:81-105): clamp u, flip v, nearest-neighbor
    # lookup.  FLAT-1D packed-u32 gather: one 32-bit load per texel
    # instead of a 4D uint8 gather; the in-jit pack is one cheap
    # elementwise pass over the atlas and the texels are bit-identical.
    ah, aw = atlas.shape[1], atlas.shape[2]
    a32 = atlas.astype(jnp.uint32)
    flat_atlas = ((a32[..., 0] << 16) | (a32[..., 1] << 8)
                  | a32[..., 2]).reshape(-1)
    slot = jnp.maximum(tex_id, 0)
    hw = tex_hw[slot]  # [R,2]
    h = hw[:, 0]
    w = hw[:, 1]
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    i = jnp.minimum((uu * w.astype(u.dtype)).astype(jnp.int32), w - 1)
    j = jnp.minimum((vv * h.astype(u.dtype)).astype(jnp.int32), h - 1)
    i = jnp.maximum(i, 0)
    j = jnp.maximum(j, 0)
    tex32 = flat_atlas[(slot * ah + j) * aw + i]
    texel = jnp.stack([(tex32 >> 16).astype(jnp.float32),
                       ((tex32 >> 8) & 0xFF).astype(jnp.float32),
                       (tex32 & 0xFF).astype(jnp.float32)],
                      axis=-1) * (1.0 / 255.0)  # [R,3]
    missing = jnp.asarray(_MISSING_IMAGE_COLOR, jnp.float32)
    # empty slots (never loaded / freed) count as missing data like the
    # reference's nullptr check (Texture.cuh:88-89)
    valid = (tex_id >= 0) & (h > 0) & (w > 0)
    image = jnp.where(valid[:, None], texel, missing[None, :])

    # --- noise/marble (BEYOND-REFERENCE, ops/noise.py): tex_id = scale
    scale = jnp.maximum(tex_id, 1).astype(p.dtype)
    fac = marble_factor(p[:, 0], p[:, 1], p[:, 2], scale, xp=jnp)
    marble = albedo2 + fac[:, None] * (albedo - albedo2)

    out = albedo
    out = jnp.where((tex_type == CHECKER)[:, None], checker, out)
    out = jnp.where((tex_type == IMAGE)[:, None], image, out)
    out = jnp.where((tex_type == NOISE)[:, None], marble, out)
    return out
