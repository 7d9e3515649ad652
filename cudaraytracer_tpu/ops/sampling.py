"""Importance sampling: light/cosine mixture PDFs (RTOW book 3).

BEYOND-REFERENCE: the CUDA reference implements the book-1/2 feature set
(its lambertian scatters ``normal + in_unit_sphere`` with no PDF
weighting, Material.cuh:44-62) and has no importance sampling.  This
module adds the "Ray Tracing: The Rest of Your Life" estimator — at
every TRUE-lambertian scatter the new direction is drawn from a mixture
of the cosine density and the solid-angle density of the scene's lights,
and the path throughput is weighted by ``scattering_pdf / mixture_pdf``.
The estimate is unbiased for ANY mixture weight (the sampler and the
pdf evaluator agree by construction — test_nee.py integrates the
cosine lobe against the mixture to 1.0), and light-driven scenes
(Cornell) converge several times faster at equal spp.

Everything here is wavefront-vectorized over a ray batch and built from
select-gated closed forms — no per-lane control flow, no gathers beyond
an 8-slot light table (the light table is tiny and the per-ray work is
a handful of elementwise ops per light slot).

Supported light geometry: spheres, the three axis-aligned rect
orientations (prim types 0-3) AND triangles (prim type 4 — uniform-area
sampling with the standard sqrt-barycentric map; the pdf is the
area-measure density converted to solid angle, dist^2 / (cos * area),
evaluated through a Moller-Trumbore hit test) with material
DIFFUSE_LIGHT.  Mesh emitters therefore get the full variance
reduction, one table slot per emissive triangle.  MOVING emitters fall
back to BSDF sampling (the table holds static geometry; they still
light the scene through the cosine component — the estimator stays
unbiased, only the variance reduction skips them).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.vec import cross, dot, normalize
from . import intersect, materials

MAX_LIGHTS = 8  # fixed light-table capacity: shapes never depend on the
# scene, so edits/deletes never recompile (same design as the SoA scene)

_INV_PI = 0.3183098861837907


def collect_lights(scene, max_lights: int = MAX_LIGHTS):
    """Fixed-shape light table from SceneData (all TRACED — no recompile
    on edits).  Returns (l_type i32[L], l_center f32[L,3],
    l_size f32[L,2], l_e1 f32[L,3], l_e2 f32[L,3], l_valid f32[L],
    n_lights f32 scalar).

    A "light" is an active sphere/rect/triangle with material
    DIFFUSE_LIGHT and intensity > 0 (degenerate zero-area triangles are
    excluded — their solid-angle pdf is undefined).  ``lax.top_k`` on
    the 0/1 mask picks the first ``max_lights`` of them (stable: equal
    scores keep index order); overflow lights beyond the table simply
    lose importance sampling (still rendered correctly through the
    cosine component).
    """
    tri_n = cross(scene.edge1, scene.edge2)
    tri_area2 = jnp.sum(tri_n * tri_n, axis=1)  # (2*area)^2
    is_tri = scene.prim_type == intersect.TRIANGLE
    geom_ok = jnp.where(is_tri, tri_area2 > 1e-16,
                        scene.prim_type <= intersect.YZ_RECT)
    is_l = (scene.active
            & (scene.mat_type == materials.DIFFUSE_LIGHT)
            & geom_ok
            & (scene.light > 0.0)
            # moving lights are excluded: the table holds the STATIC
            # center, and a pdf evaluated there would bias the shutter-
            # time render — movers fall back to cosine sampling
            & jnp.all(scene.velocity == 0.0, axis=1))
    score = is_l.astype(jnp.float32)
    k = min(max_lights, int(scene.prim_type.shape[0]))
    _, lidx = lax.top_k(score, k)
    if k < max_lights:
        lidx = jnp.pad(lidx, (0, max_lights - k))
    l_valid = score[lidx]
    l_type = scene.prim_type[lidx]
    l_center = scene.center[lidx]  # triangle: v0
    l_size = scene.size[lidx]
    l_e1 = scene.edge1[lidx]
    l_e2 = scene.edge2[lidx]
    # the table may truncate: n_lights counts TABLED lights only, so the
    # uniform pick and the pdf average stay mutually consistent
    n_lights = jnp.sum(l_valid)
    return l_type, l_center, l_size, l_e1, l_e2, l_valid, n_lights


def _rect_axes(l_type):
    """Per-light rect axis indices + half extents (intersect.py
    _K_AXIS/_A_AXIS/_B_AXIS/_A_EXT_COL conventions, Hittable.cuh:128-294)."""
    k_ax = jnp.asarray(intersect._K_AXIS)[jnp.clip(l_type, 0, 3)]
    a_ax = jnp.asarray(intersect._A_AXIS)[jnp.clip(l_type, 0, 3)]
    b_ax = jnp.asarray(intersect._B_AXIS)[jnp.clip(l_type, 0, 3)]
    return k_ax, a_ax, b_ax


def _rect_halves(l_type, l_size):
    ea = jnp.asarray(intersect._A_EXT_COL)[jnp.clip(l_type, 0, 3)]
    half_a = 0.5 * jnp.where(ea == 0, l_size[..., 0], l_size[..., 1])
    half_b = 0.5 * jnp.where(ea == 0, l_size[..., 1], l_size[..., 0])
    return half_a, half_b


def _onb(w):
    """Orthonormal basis around unit w (book 3 ONB, branch-free)."""
    a = jnp.where(jnp.abs(w[..., 0:1]) > 0.9,
                  jnp.asarray([0.0, 1.0, 0.0], w.dtype),
                  jnp.asarray([1.0, 0.0, 0.0], w.dtype))
    v = normalize(cross(w, a))
    u = cross(w, v)
    return u, v


def cosine_direction(normal, key, shape):
    """Unit direction with density cos(theta)/pi about ``normal`` — the
    TRUE-lambertian scatter (normal + random UNIT vector, normalized;
    book-1 "true Lambertian" / book-3 CosinePDF)."""
    from ..utils import rng as rngu

    s = rngu.unit_vector(key, shape)
    d = normal + s
    # degenerate when s == -normal: fall back to the normal itself
    n2 = jnp.sum(d * d, axis=-1, keepdims=True)
    d = jnp.where(n2 < 1e-12, normal, d)
    return normalize(d)


def sample_light_direction(point, l_type, l_center, l_size, l_e1, l_e2,
                           l_valid, n_lights, u_pick, u_a, u_b):
    """Draw one light-sampled unit direction per ray.

    Picks a table slot uniformly (u_pick), then samples the slot's
    geometry: rects take a uniform area point (book 3 XZRect::Random,
    generalized to all three orientations); spheres take a uniform
    direction in the cone subtended from ``point`` (book 3
    Sphere::Random) — a point INSIDE a sphere light degrades the cone to
    the full sphere (cos_max -> -1, uniform 4pi); triangles take a
    uniform area point via the sqrt-barycentric map
    (b1, b2) = (sqrt(u)(1-v), sqrt(u)v) — and ``lights_pdf`` evaluates
    the identical density, so the mixture weight never depends
    on which sample was drawn (that would invalidate the pdf).  Returns
    (dir f32[R,3], ok bool[R]); ``ok`` is False only when the table has
    no lights at all.
    """
    r = point.shape[0]
    nl = jnp.maximum(n_lights, 1.0)
    slot = jnp.clip((u_pick * nl).astype(jnp.int32), 0,
                    l_type.shape[0] - 1)
    lt = l_type[slot]  # [R]
    lc = l_center[slot]  # [R,3]
    ls = l_size[slot]  # [R,2]
    le1 = l_e1[slot]  # [R,3]
    le2 = l_e2[slot]  # [R,3]
    ok = l_valid[slot] > 0.0

    # ---- rect: uniform point on the light's area ----
    k_ax, a_ax, b_ax = _rect_axes(lt)
    half_a, half_b = _rect_halves(lt, ls)
    axes3 = jnp.arange(3, dtype=jnp.int32)
    a_oh = (a_ax[:, None] == axes3[None, :]).astype(point.dtype)
    b_oh = (b_ax[:, None] == axes3[None, :]).astype(point.dtype)
    off = (a_oh * ((u_a - 0.5) * 2.0 * half_a)[:, None]
           + b_oh * ((u_b - 0.5) * 2.0 * half_b)[:, None])
    rect_dir = normalize(lc + off - point)

    # ---- sphere: uniform direction in the subtended cone ----
    radius = ls[:, 0]
    to_c = lc - point
    dd = jnp.sum(to_c * to_c, axis=-1)
    outside = dd > radius * radius * (1.0 + 1e-6)
    cos_max = jnp.where(
        outside,
        jnp.sqrt(jnp.maximum(1.0 - radius * radius
                             / jnp.maximum(dd, 1e-20), 0.0)),
        -1.0)  # inside the light: uniform over the full sphere
    z = 1.0 + u_b * (cos_max - 1.0)  # uniform in [cos_max, 1]
    phi = (2.0 * jnp.pi) * u_a
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    w = normalize(to_c)
    u_ax, v_ax = _onb(w)
    sph_dir = (u_ax * (jnp.cos(phi) * s)[:, None]
               + v_ax * (jnp.sin(phi) * s)[:, None]
               + w * z[:, None])

    # ---- triangle: uniform area point (sqrt-barycentric map) ----
    su = jnp.sqrt(u_a)
    b1 = (su * (1.0 - u_b))[:, None]
    b2 = (su * u_b)[:, None]
    tri_dir = normalize(lc + le1 * b1 + le2 * b2 - point)

    is_sphere = lt == intersect.SPHERE
    is_tri = lt == intersect.TRIANGLE
    dirn = jnp.where(is_sphere[:, None], sph_dir,
                     jnp.where(is_tri[:, None], tri_dir, rect_dir))
    ok = ok & (n_lights > 0.0)
    return dirn, ok


def lights_pdf(point, dirn, l_type, l_center, l_size, l_e1, l_e2,
               l_valid, n_lights, t_min: float = 1e-3):
    """Solid-angle density of ``sample_light_direction`` at (point, dir):
    the average over tabled lights of each light's directional pdf
    (book 3 HittablePDF over a light list).  dirn must be unit length.
    Triangles: dist^2 / (|cos| * area) behind a Moller-Trumbore hit test
    (double-sided, matching the double-sided rect |cos|).
    Returns f32[R] (0 where no light is hittable along dir)."""
    # broadcast [R, L]
    p = point[:, None, :]
    d = dirn[:, None, :]
    lt = l_type[None, :]

    # ---- rect pdf: dist^2 / (cos * area) if the ray hits the rect ----
    k_ax, a_ax, b_ax = _rect_axes(l_type)
    half_a, half_b = _rect_halves(l_type, l_size)
    axes3 = jnp.arange(3, dtype=jnp.int32)
    k_oh = (k_ax[:, None] == axes3[None, :]).astype(point.dtype)  # [L,3]
    a_oh = (a_ax[:, None] == axes3[None, :]).astype(point.dtype)
    b_oh = (b_ax[:, None] == axes3[None, :]).astype(point.dtype)
    o_k = jnp.sum(p * k_oh[None], -1)  # [R,L]
    d_k = jnp.sum(d * k_oh[None], -1)
    c_k = jnp.sum(l_center * k_oh, -1)[None, :]
    t_r = (c_k - o_k) / jnp.where(d_k == 0.0, 1e-30, d_k)
    o_a = jnp.sum(p * a_oh[None], -1)
    d_a = jnp.sum(d * a_oh[None], -1)
    o_b = jnp.sum(p * b_oh[None], -1)
    d_b = jnp.sum(d * b_oh[None], -1)
    c_a = jnp.sum(l_center * a_oh, -1)[None, :]
    c_b = jnp.sum(l_center * b_oh, -1)[None, :]
    hit_r = ((t_r > t_min)
             & (jnp.abs(o_a + t_r * d_a - c_a) <= half_a[None, :])
             & (jnp.abs(o_b + t_r * d_b - c_b) <= half_b[None, :]))
    area = 4.0 * half_a * half_b  # (2ha)(2hb)
    cos_l = jnp.abs(d_k)
    rect_pdf = jnp.where(
        hit_r,
        (t_r * t_r) / jnp.maximum(cos_l * area[None, :], 1e-12),
        0.0)

    # ---- sphere pdf: 1 / (2 pi (1 - cos_max)) inside the cone ----
    radius = l_size[None, :, 0]
    to_c = l_center[None, :, :] - p  # [R,L,3]
    dd = jnp.sum(to_c * to_c, -1)
    outside = dd > radius * radius * (1.0 + 1e-6)
    cos_max = jnp.where(
        outside,
        jnp.sqrt(jnp.maximum(1.0 - radius * radius
                             / jnp.maximum(dd, 1e-20), 0.0)),
        -1.0)  # inside: the sampler degraded to uniform 4pi
    cos_dir = jnp.sum(d * to_c, -1) * lax.rsqrt(jnp.maximum(dd, 1e-20))
    in_cone = cos_dir >= cos_max
    solid = (2.0 * jnp.pi) * (1.0 - cos_max)
    sph_pdf = jnp.where(in_cone & (solid > 1e-12),
                        1.0 / jnp.maximum(solid, 1e-12), 0.0)

    # ---- triangle pdf: dist^2 / (|cos| * area) behind an MT hit ----
    e1 = l_e1[None, :, :]  # [1,L,3]
    e2 = l_e2[None, :, :]
    tn = cross(l_e1, l_e2)  # [L,3]
    tn2 = jnp.sum(tn * tn, -1)
    t_area = 0.5 * jnp.sqrt(jnp.maximum(tn2, 0.0))
    tn_hat = tn * lax.rsqrt(jnp.maximum(tn2, 1e-20))[:, None]
    h = cross(d, e2)  # [R,L,3]
    det = jnp.sum(e1 * h, -1)
    det_ok = jnp.abs(det) > 1e-9
    inv = 1.0 / jnp.where(det_ok, det, 1.0)
    s_v = p - l_center[None, :, :]
    bu = inv * jnp.sum(s_v * h, -1)
    q = cross(s_v, e1)
    bv = inv * jnp.sum(d * q, -1)
    t_t = inv * jnp.sum(e2 * q, -1)
    hit_t = (det_ok & (bu >= 0.0) & (bv >= 0.0) & (bu + bv <= 1.0)
             & (t_t > t_min))
    cos_t = jnp.abs(jnp.sum(d * tn_hat[None], -1))
    tri_pdf = jnp.where(
        hit_t,
        (t_t * t_t) / jnp.maximum(cos_t * t_area[None, :], 1e-12),
        0.0)

    is_sphere = lt == intersect.SPHERE
    is_tri = lt == intersect.TRIANGLE
    per_light = (jnp.where(is_sphere, sph_pdf,
                           jnp.where(is_tri, tri_pdf, rect_pdf))
                 * l_valid[None, :])
    return jnp.sum(per_light, -1) / jnp.maximum(n_lights, 1.0)


def nee_lambertian(rec_point, rec_normal, tex_color, lights, key, r,
                   p_light, t_min: float = 1e-3):
    """One mixture-sampled TRUE-lambertian scatter for a ray batch.

    Returns (direction f32[R,3] unit, attenuation f32[R,3],
    alive bool[R]).  attenuation = tex * scattering_pdf / mixture_pdf
    with scattering_pdf = max(cos, 0)/pi (book 3's
    ScatteringPDF/PDFValue ratio); lanes whose sampled direction dips
    below the surface or whose pdf vanishes terminate with zero
    contribution (exactly what the integrand assigns them).
    """
    l_type, l_center, l_size, l_e1, l_e2, l_valid, n_lights = lights
    k_cos, k_mix, k_pick, k_a, k_b = jax.random.split(key, 5)
    u_mix = jax.random.uniform(k_mix, (r,))
    u_pick = jax.random.uniform(k_pick, (r,))
    u_a = jax.random.uniform(k_a, (r,))
    u_b = jax.random.uniform(k_b, (r,))

    dir_cos = cosine_direction(rec_normal, k_cos, (r,))
    dir_l, ok_l = sample_light_direction(
        rec_point, l_type, l_center, l_size, l_e1, l_e2, l_valid,
        n_lights, u_pick, u_a, u_b)
    # effective mixture weight: 0 when the table is empty (pure cosine).
    # Scene-dependent only — NEVER sample-dependent (a weight that
    # depended on the drawn sample would invalidate the density); ok_l
    # is exactly (n_lights > 0), constant across lanes
    del ok_l
    p_eff = jnp.where(n_lights > 0.0, p_light, 0.0)
    take_light = u_mix < p_eff
    dirn = jnp.where(take_light[:, None], dir_l, dir_cos)

    cos_d = dot(rec_normal, dirn)
    scat_pdf = jnp.maximum(cos_d, 0.0) * _INV_PI
    lpdf = lights_pdf(rec_point, dirn, l_type, l_center, l_size,
                      l_e1, l_e2, l_valid, n_lights, t_min=t_min)
    pdf = (1.0 - p_eff) * scat_pdf + p_eff * lpdf
    alive = pdf > 1e-9
    w = scat_pdf / jnp.maximum(pdf, 1e-9)
    attenuation = tex_color * jnp.where(alive, w, 0.0)[:, None]
    return dirn, attenuation, alive
