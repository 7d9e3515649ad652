"""First-hit feature buffers (G-buffer) for denoising.

Beyond-reference subsystem (the CUDA reference has no denoiser or AOVs;
its kernel writes only the beauty image, Kernel.cu:102-158).  Instead of
threading extra output planes through the bounce loop, the G-buffer is ONE
deterministic primary-visibility pass — normals,
albedo and depth are functions of (scene, camera) only, so they are
computed once per camera/scene edit and cached, never per accumulation
frame.  The pass reuses the exact production intersection and texture
stack (the renderer's hit function, ops/textures.py), so features can never
drift from what the renderer actually hits.

Buffers (all f32, image-shaped):
  * normal f32[H,W,3] — geometric front-facing unit normal (smooth
    shading normals when the scene carries vertex attrs); zeros on miss.
  * albedo f32[H,W,3] — first-hit texture color (constant/checker/image,
    Texture.cuh:32-109 semantics); the sky gradient on miss so the
    background is its own edge-stopping region.
  * depth  f32[H,W]   — ray parameter t of the first hit; 0 on miss
    (a distinct plateau, so sky/geometry boundaries stop the filter).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.camera import RAY_GENERATORS, CameraParams
from ..models.scene import SceneData
from ..ops import intersect, textures
from ..ops.sky import sky_color


class GBuffer(NamedTuple):
    normal: jnp.ndarray  # f32[H,W,3]
    albedo: jnp.ndarray  # f32[H,W,3]
    depth: jnp.ndarray  # f32[H,W]


def primary_features(
    scene: SceneData,
    cam: CameraParams,
    *,
    width: int,
    height: int,
    camera_model: str = "two_plane",
    t_min: float = 0.001,
    block: int = 64,
    hit_fn=None,
) -> GBuffer:
    """One deterministic primary-visibility pass -> GBuffer.

    Rays are pixel-CENTER pinhole rays (raygen key=None): the buffers are
    a pure function of (scene, camera) — bitwise-stable across frames, so
    the per-camera-version cache in the viewer stays valid.  ``hit_fn``
    defaults to the brute scan over every primitive except media; the
    viewer passes the BVH hit function built with ``media=False``
    (models/bvh.py), which sees the same surfaces.
    """
    raygen = RAY_GENERATORS[camera_model]
    org, dirn = raygen(cam, width, height, None)

    tri_kw = (
        dict(edge1=scene.edge1, edge2=scene.edge2)
        if scene.has_triangles else {}
    )
    rec_kw = dict(tri_kw)
    if scene.has_triangles and scene.has_vertex_attrs:
        rec_kw.update(
            uv0=scene.uv0, uv1=scene.uv1, uv2=scene.uv2,
            vnorm0=scene.vnorm0, vnorm1=scene.vnorm1, vnorm2=scene.vnorm2,
        )
    # constant-density media have no surface: the feature buffers see
    # THROUGH them, so fog never poisons the denoiser's edge stopping
    act = scene.active
    if scene.has_media:
        act = act & (scene.mat_type != 4)  # materials.ISOTROPIC
    if hit_fn is None:
        def hit_fn(o, d):
            return intersect.hit_scene(
                o, d, scene.prim_type, scene.center, scene.size,
                act, t_min=t_min, block=block, **tri_kw,
            )
    hit, t, idx = hit_fn(org, dirn)
    rec = intersect.make_hit_record(
        org, dirn, hit, t, idx, scene.prim_type, scene.center, scene.size,
        **rec_kw,
    )
    safe = jnp.maximum(idx, 0)
    albedo = textures.sample_texture(
        scene.tex_type[safe], scene.albedo[safe], scene.albedo2[safe],
        scene.tex_id[safe], rec.u, rec.v, rec.point,
        scene.atlas, scene.tex_hw,
    )
    sky = sky_color(dirn, scene.background_start, scene.background_end)
    albedo = jnp.where(hit[:, None], albedo, sky)

    # front-facing normal: the sphere record keeps the raw outward normal
    # (dielectric sign convention, Hittable.cuh:90-110); flip it to the
    # viewer side so both faces of a surface are ONE feature region
    n = rec.normal
    n = jnp.where(jnp.sum(n * dirn, axis=-1, keepdims=True) > 0.0, -n, n)
    normal = jnp.where(hit[:, None], n, 0.0)
    # depth = WORLD-SPACE distance to the first hit (look_at raygen dirs
    # are unnormalized, so raw t is in |dir| units)
    dist = t * jnp.sqrt(jnp.sum(dirn * dirn, axis=-1))
    depth = jnp.where(hit, dist, 0.0)

    return GBuffer(
        normal=normal.reshape(height, width, 3),
        albedo=albedo.reshape(height, width, 3),
        depth=depth.reshape(height, width),
    )


@functools.lru_cache(maxsize=8)
def gbuffer_step(width: int, height: int, camera_model: str,
                 t_min: float = 0.001, block: int = 64):
    """Jitted ``(scene, cam, bvh=None) -> GBuffer``, cached per static
    shape: one compiled dispatch per camera/scene edit.  With a ``bvh``
    the first hit goes through the renderer's BVH hit function
    (models/bvh.py); without one, the brute scan."""
    from ..models.bvh import make_bvh_hit_fn

    @jax.jit
    def _run(scene: SceneData, cam: CameraParams, bvh=None) -> GBuffer:
        hit_fn = None if bvh is None else make_bvh_hit_fn(
            bvh, scene, t_min=t_min, media=False)
        return primary_features(
            scene, cam, width=width, height=height,
            camera_model=camera_model, t_min=t_min, block=block,
            hit_fn=hit_fn,
        )

    return _run
