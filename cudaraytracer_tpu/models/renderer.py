"""The render engine: wavefront path tracing under jit.

Re-architecture of the reference's CUDA render kernel
(reference: CudaRayTracer/src/Cuda/Kernel.cu:102-158) and its radiance loop
``color()`` (Kernel.cu:30-80):

  * One ray per pixel per sample, all pixels traced together as a flat
    wavefront ``[R]`` instead of one CUDA thread per pixel.
  * The bounce loop is a ``lax.while_loop`` with an ``alive`` mask and an
    early-exit condition ``(bounce < max_depth) & any(alive)`` — dead lanes
    are masked rather than divergent, and the loop stops as soon as every
    ray has terminated (the reference always pays for the longest thread in
    a warp; here the whole wavefront exits together).
  * ``max_depth`` and ``spp`` are traced scalars, so the live UI sliders
    (reference CudaLayer.cpp:675-682) never trigger recompilation.
  * RNG is counter-based: key = fold_in(fold_in(base, sample), bounce).

The brute-force closest-hit over the SoA scene is ops.intersect.hit_scene;
a BVH-accelerated traversal can be swapped in via ``accel=``.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import intersect, materials, sampling, textures
from ..ops.sky import sky_color
from ..ops.pack import pack_rgba8, tonemap
from ..utils import rng as rngu
from .camera import RAY_GENERATORS, CameraParams
from .scene import SceneData


def trace(
    scene: SceneData,
    org: jnp.ndarray,
    dirn: jnp.ndarray,
    key: jax.Array,
    max_depth,
    t_min: float = 0.001,
    block: int = 64,
    hit_fn: Callable | None = None,
    with_stats: bool = False,
    rr_start: int = 0,
    nee: bool = False,
    nee_p: float = 0.5,
):
    """Trace a ray wavefront to completion; returns radiance f32[R,3]
    (plus the number of rays traced — primary + bounces — if with_stats).

    ``rr_start > 0`` enables Russian-roulette path termination from that
    bounce (unbiased: survivors are compensated by 1/p).

    ``nee=True`` (STATIC) switches lambertian scatters to the RTOW
    book-3 importance-sampled estimator (ops/sampling.py): TRUE-cosine
    lambertian mixed with light solid-angle sampling at weight ``nee_p``,
    throughput weighted by scattering_pdf / mixture_pdf.  BEYOND-
    REFERENCE (the CUDA reference has no PDFs) and a DIFFERENT transport
    than the default: the reference's lambertian is the book-1
    normal+in_unit_sphere approximation, kept as the parity default.

    Faithful to color() (Kernel.cu:30-80): miss -> sky gradient * throughput;
    diffuse light -> emitted * throughput, terminate; scatter failure ->
    black; depth exhausted -> black.
    """
    r = org.shape[0]
    max_depth = jnp.asarray(max_depth, jnp.int32)

    # scene.has_triangles / has_vertex_attrs are STATIC pytree metadata:
    # triangle-free scenes trace the identical (triangle-less) graph they
    # always did, and plain-triangle scenes skip the per-vertex
    # interpolation code entirely
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
    # constant-density media (scene.has_media is STATIC): the hit fn takes
    # a per-ray uniform per wave for the stochastic scatter distance, and
    # the record marks medium winners (arbitrary normal, isotropic phase)
    if scene.has_media:
        rec_kw.update(mat_type=scene.mat_type)
    # moving spheres (scene.has_motion is STATIC): one shutter time per
    # PATH (drawn below, constant across its bounces) shifts sphere
    # centers; the record reconstructs the normal at that time
    if scene.has_motion:
        rec_kw.update(velocity=scene.velocity)

    if hit_fn is None:
        if scene.has_media or scene.has_motion:
            med_kw = (dict(mat_type=scene.mat_type, density=scene.density)
                      if scene.has_media else {})
            if scene.has_media and scene.has_box_media:
                # box-bounded media: half-extents ride the edge1 rows
                med_kw["half_ext"] = scene.edge1
                if scene.has_rot_media:
                    # yaw-rotated boxes (rotate_y): yaw rides edge2[:,0]
                    med_kw["yaw"] = scene.edge2[:, 0]

            def hit_fn(o, d, u_med=None, time=None):
                mot_kw = (dict(velocity=scene.velocity, time=time)
                          if scene.has_motion else {})
                return intersect.hit_scene(
                    o, d, scene.prim_type, scene.center, scene.size,
                    scene.active, t_min=t_min, block=block,
                    u_med=u_med, **med_kw, **mot_kw, **tri_kw,
                )
        else:
            def hit_fn(o, d):
                return intersect.hit_scene(
                    o, d, scene.prim_type, scene.center, scene.size,
                    scene.active, t_min=t_min, block=block, **tri_kw,
                )

    # one shutter time per path, frozen across its bounces (RTOW book-2
    # camera::get_ray semantics)
    shutter = (jax.random.uniform(jax.random.fold_in(key, 17), (r,))
               if scene.has_motion else None)

    # importance sampling: fixed-shape light table (all traced — scene
    # edits never recompile; the nee TOGGLE is static, like accel)
    lights = sampling.collect_lights(scene) if nee else None

    def cond(carry):
        _, _, _, _, alive, bounce, _ = carry
        return (bounce < max_depth) & jnp.any(alive)

    def body(carry):
        org, dirn, throughput, radiance, alive, bounce, nrays = carry
        nrays = nrays + jnp.sum(alive, dtype=jnp.float32)
        bkey = rngu.bounce_key(key, bounce)
        k_sphere, k_uniform = jax.random.split(bkey)

        if scene.has_media or scene.has_motion:
            u_med = (jax.random.uniform(jax.random.fold_in(bkey, 13), (r,))
                     if scene.has_media else None)
            hit, t, idx = hit_fn(org, dirn, u_med=u_med, time=shutter)
        else:
            hit, t, idx = hit_fn(org, dirn)
        mot_rec = dict(time=shutter) if scene.has_motion else {}
        rec = intersect.make_hit_record(
            org, dirn, hit, t, idx, scene.prim_type, scene.center, scene.size,
            **rec_kw, **mot_rec,
        )

        # ---- miss: sky gradient (Kernel.cu:40-45) ----
        sky = sky_color(dirn, scene.background_start, scene.background_end)
        miss = alive & ~hit
        radiance = radiance + jnp.where(miss[:, None], throughput * sky, 0.0)

        # ---- hit: sample texture, scatter (Kernel.cu:47-77) ----
        safe = jnp.maximum(idx, 0)
        tex_color = textures.sample_texture(
            scene.tex_type[safe],
            scene.albedo[safe],
            scene.albedo2[safe],
            scene.tex_id[safe],
            rec.u, rec.v, rec.point,
            scene.atlas, scene.tex_hw,
        )
        sc = materials.scatter(
            dirn, rec.point, rec.normal,
            scene.mat_type[safe], scene.fuzz[safe], scene.ior[safe],
            scene.light[safe], tex_color,
            rngu.in_unit_sphere(k_sphere, (r,)),
            jax.random.uniform(k_uniform, (r,)),
        )

        lit = alive & hit
        radiance = radiance + jnp.where(lit[:, None], throughput * sc.emitted, 0.0)

        direction = sc.direction
        scattered_mask = sc.scattered
        attenuation = sc.attenuation
        if nee:
            # book-3 mixture-sampled lambertian (module docstring): the
            # other materials keep their delta/phase samplers (book 3
            # does the same for specular)
            is_lamb = hit & (scene.mat_type[safe] == materials.LAMBERTIAN)
            d_nee, a_nee, ok_nee = sampling.nee_lambertian(
                rec.point, rec.normal, tex_color, lights,
                jax.random.fold_in(bkey, 23), r, nee_p, t_min=t_min)
            direction = jnp.where(is_lamb[:, None], d_nee, direction)
            attenuation = jnp.where(is_lamb[:, None], a_nee, attenuation)
            scattered_mask = jnp.where(is_lamb, ok_nee, scattered_mask)

        cont = lit & scattered_mask
        if rr_start > 0:
            new_tp = throughput * attenuation
            p_surv = jnp.clip(jnp.max(new_tp, axis=-1), 0.05, 1.0)
            k_rr = jax.random.fold_in(bkey, 7)
            do_rr = bounce >= rr_start
            survive = ~do_rr | (jax.random.uniform(k_rr, (r,)) < p_surv)
            attenuation = attenuation / jnp.where(do_rr, p_surv, 1.0)[:, None]
            cont = cont & survive
        org = jnp.where(cont[:, None], rec.point, org)
        dirn = jnp.where(cont[:, None], direction, dirn)
        throughput = jnp.where(cont[:, None], throughput * attenuation, throughput)

        return org, dirn, throughput, radiance, cont, bounce + 1, nrays

    init = (
        org,
        dirn,
        jnp.ones_like(org),
        jnp.zeros_like(org),
        jnp.full_like(org[:, 0], True, dtype=bool),
        jnp.int32(0),
        jnp.zeros_like(org[0, 0]),
    )
    _, _, _, radiance, _, _, nrays = lax.while_loop(cond, body, init)
    if with_stats:
        return radiance, nrays
    return radiance


def render_radiance(
    scene: SceneData,
    cam: CameraParams,
    key: jax.Array,
    spp,
    max_depth,
    *,
    width: int,
    height: int,
    camera_model: str = "two_plane",
    t_min: float = 0.001,
    block: int = 64,
    hit_fn: Callable | None = None,
    y0=0,
    tile_h: int | None = None,
    sample_offset=0,
    with_stats: bool = False,
    rr_start: int = 0,
    nee: bool = False,
    nee_p: float = 0.5,
    qmc: bool = False,
):
    """Sum of ``spp`` radiance samples, f32[tile_h,W,3] (divide by spp to display).

    The sample loop is the analog of the spp loop in the reference kernel
    (Kernel.cu:137-148) but sequential over full-frame wavefronts; spp is a
    traced scalar so the UI slider costs no recompile.  ``y0``/``tile_h``
    render a horizontal band (multi-chip row sharding); ``sample_offset``
    shifts the sample counter so sample-sharded chips draw disjoint streams.
    ``qmc`` (STATIC, like the estimator switch) replaces the PRNG pixel
    jitter with the R2 low-discrepancy sequence (ops/qmc.py); the global
    sample index is ``s + sample_offset``, so progressive callers MUST pass
    the accumulated sample count as ``sample_offset`` to keep advancing the
    sequence across frames (repeating indices would floor the error).
    """
    if tile_h is None:
        tile_h = height
    raygen = RAY_GENERATORS[camera_model]
    spp = jnp.asarray(spp, jnp.int32)
    if qmc:
        from ..ops import qmc as qmcm

        xg = jnp.arange(width, dtype=jnp.float32)[None, :]
        yg = (jnp.arange(tile_h, dtype=jnp.float32)
              + jnp.asarray(y0, jnp.float32))[:, None]
        xg, yg = jnp.broadcast_to(xg, (tile_h, width)), jnp.broadcast_to(
            yg, (tile_h, width))

    def sample_body(s, carry):
        acc, total = carry
        skey = rngu.frame_key(key, s + sample_offset)
        # fold the row band in so tiles draw independent jitter streams
        skey = jax.random.fold_in(skey, jnp.asarray(y0, jnp.int32))
        k_pix, k_trace = jax.random.split(skey)
        xi = None
        if qmc:
            jx, jy = qmcm.qmc_jitter(
                xg, yg, jnp.asarray(s + sample_offset, jnp.int32))
            xi = jnp.stack([jx, jy])
        org, dirn = raygen(cam, width, height, k_pix, y0=y0, tile_h=tile_h,
                           xi=xi)
        rad, nrays = trace(
            scene, org, dirn, k_trace, max_depth,
            t_min=t_min, block=block, hit_fn=hit_fn, with_stats=True,
            rr_start=rr_start, nee=nee, nee_p=nee_p,
        )
        return acc + rad.reshape(tile_h, width, 3), total + nrays

    acc, total = lax.fori_loop(
        0, spp, sample_body,
        (jnp.zeros((tile_h, width, 3), jnp.float32), jnp.float32(0.0)),
    )
    if with_stats:
        return acc, total
    return acc


class Renderer:
    """Jit-compiled frame renderer with a fixed (width, height, accel) config.

    The compiled function is keyed only on shapes/static config; scene edits,
    camera motion, spp, and max_depth are all traced inputs (no recompiles,
    unlike the reference which re-launches a fully dynamic kernel each frame).
    """

    def __init__(
        self,
        width: int,
        height: int,
        camera_model: str = "two_plane",
        t_min: float = 0.001,
        block: int = 64,
        accel: str = "brute",
        nee: bool = False,
        nee_p: float = 0.5,
        qmc: bool = False,
    ):
        self.width = int(width)
        self.height = int(height)
        self.camera_model = camera_model
        self.t_min = t_min
        self.block = block
        self.accel = accel
        self.nee = bool(nee)  # estimator switch: recompiles, like accel
        self.nee_p = float(nee_p)
        self.qmc = bool(qmc)  # low-discrepancy pixel jitter (ops/qmc.py)

        def _make_hit_fn(scene, bvh):
            if bvh is None:
                return None
            from .bvh import make_bvh_hit_fn

            return make_bvh_hit_fn(bvh, scene, t_min=self.t_min)

        @functools.partial(jax.jit, static_argnames=("with_stats",))
        def _render(scene, bvh, cam, key, spp, max_depth, with_stats=False,
                    sample_offset=0):
            return render_radiance(
                scene, cam, key, spp, max_depth,
                width=self.width, height=self.height,
                camera_model=self.camera_model,
                t_min=self.t_min, block=self.block,
                hit_fn=_make_hit_fn(scene, bvh),
                with_stats=with_stats,
                nee=self.nee, nee_p=self.nee_p, qmc=self.qmc,
                sample_offset=jnp.asarray(sample_offset, jnp.int32),
            )

        self._render = _render

        @jax.jit
        def _accumulate(scene, bvh, cam, key, max_depth, accum,
                        sample_offset=0):
            # progressive QMC: the caller passes its accumulated sample
            # count so the R2 index keeps advancing across frames
            rad = _render(scene, bvh, cam, key, 1, max_depth,
                          sample_offset=sample_offset)
            return accum + rad

        self._accumulate = _accumulate
        self._pack = jax.jit(pack_rgba8)
        self._tonemap = jax.jit(tonemap)

    # ------------------------------------------------------------- API
    def render(self, scene, cam, key, spp=36, max_depth=12, bvh=None, with_stats=False):
        """Radiance sum over spp samples, f32[H,W,3] (device array).

        Pass ``bvh`` (models.bvh.BVHData) to use accelerated traversal; it
        is a traced argument, so per-edit rebuilds never recompile (the
        analog of the reference's rebuild-on-drag, CudaLayer.cpp:491-556).
        """
        return self._render(scene, bvh, cam, key, spp, max_depth, with_stats=with_stats)

    def render_rgba8(self, scene, cam, key, spp=36, max_depth=12, bvh=None):
        """Full frame to display bytes, uint8[H,W,4] — the analog of one
        LaunchKernel + RgbToInt frame (Kernel.cu:102-158)."""
        rad = self._render(scene, bvh, cam, key, spp, max_depth)
        return self._pack(rad, spp)

    def accumulate(self, scene, cam, key, max_depth, accum, bvh=None,
                   sample_offset=0):
        """One progressive 1-spp sample added into ``accum`` (f32[H,W,3]).

        With ``qmc=True`` pass ``sample_offset`` = samples already in
        ``accum`` so the low-discrepancy sequence advances across frames."""
        return self._accumulate(scene, bvh, cam, key, max_depth, accum,
                                sample_offset)

    def zeros_accum(self):
        return jnp.zeros((self.height, self.width, 3), jnp.float32)
