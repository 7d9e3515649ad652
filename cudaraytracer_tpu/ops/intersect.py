"""Vectorized ray-primitive intersection.

Re-architecture of the reference's per-thread tagged-union hit
dispatch (reference: CudaRayTracer/src/Hittables/Hittable.cuh:80-294 for the
Sphere/XYRect/XZRect/YZRect `Hit` methods and Hittable.cuh:470-485 for the
`PerformHit` type switch).  Key design differences:

  * Scene is flat SoA (struct-of-arrays), not a pointer graph: primitives are
    described by ``prim_type[N]``, ``center[N,3]``, ``size[N,2]``,
    ``active[N]`` arrays resident in device memory.
  * All rays x a block of primitives are tested at once.  The sphere
    quadratic's cross terms are expressed as two ``[R,3] @ [3,B]`` matmuls
    (ray-origin·center and ray-dir·center) at HIGHEST precision (full
    f32, never TF32); everything else is ``[R,B]`` elementwise work.  No
    ``[R,B,3]`` intermediate is ever materialized.  This is the plain
    reference: the BVH path (models/bvh.py) is checked against it.
  * The closest-hit reduction runs as a ``lax.scan`` over primitive blocks so
    peak memory is ``O(R * block)`` regardless of scene size.
  * A second cheap pass reconstructs the full hit record (normal, uv,
    front_face) only for each ray's winning primitive, instead of carrying it
    through the reduction.

Primitive type encoding (matches the reference HittableType enum order,
Hittable.cuh:30-38, minus the BVH/list entries which are containers here):
    0 = sphere   (size[:,0] = radius)
    1 = xy rect  (size = (width, height), plane z = center.z, normal +z)
    2 = xz rect  (size = (width, height), plane y = center.y, normal +y)
    3 = yz rect  (size = (width, height), plane x = center.x, normal +x)
    4 = triangle (center = v0, edge1 = v1-v0, edge2 = v2-v0) — a
        BEYOND-REFERENCE primitive (the reference supports only spheres
        and axis-aligned rects); enables triangle meshes (utils.mesh).

Constant-density MEDIA (BEYOND-REFERENCE, RTOW book-2 ConstantMedium):
a sphere whose material is ISOTROPIC is a participating medium, not a
surface.  Its "hit" is stochastic: with u ~ U[0,1) the scatter distance
is -log(u)/density from the (clamped) entry point; the candidate t is
accepted iff it lies inside the boundary and beats the running closest —
order-independent, because t is a deterministic function of (ray, u).
``hit_scene`` takes (mat_type, density, u_med) to enable the branch;
media-free calls trace the identical graph they always did.

The triangle test is Moller-Trumbore re-factored as matmuls: every
numerator/denominator of (t, u, v) is a scalar triple product, and
det3[x, y, z] splits over tv = o - v0 into a per-RAY vector dotted with a
per-PRIMITIVE vector — so the whole [R,B] candidate grid is four
[R,3] @ [3,B] matmuls (det, t, u, v numerators) plus elementwise work,
with no [R,B,3] intermediate, exactly like the sphere quadratic above:
    det   = e1.(d x e2)  = -d . n2            n2 = e1 x e2
    t*det = tv . n2      = o . n2 - v0 . n2
    u*det = tv.(d x e2)  = (o x d).e2 - d.(e2 x v0)
    v*det = d.(tv x e1)  = -(o x d).e1 - d.(v0 x e1)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.vec import PI, dot

# Primitive type ids.
SPHERE = 0
XY_RECT = 1
XZ_RECT = 2
YZ_RECT = 3
TRIANGLE = 4
# Axis-aligned BOX — used exclusively as a constant-medium boundary
# (Scene.add_medium_box, the RTOW book-2 Cornell-smoke shape; the CUDA
# reference has neither boxes nor volumes).  Half-extents live in the
# scene's edge1 rows (spare for non-triangles); the boundary is invisible
# (mat is always ISOTROPIC), so no surface normal/uv is ever needed.
BOX = 5

# Degenerate-triangle guard: |det| below this means the ray is parallel to
# the triangle plane (or the triangle has ~zero area); no hit.
TRI_DET_EPS = 1e-9

# Per-type axis tables (index 0 = sphere placeholder).
# k = plane axis, a/b = in-plane axes mapped to (u, v).
# XYRect: plane z, u<-x (width),  v<-y (height)   (Hittable.cuh:139-165)
# XZRect: plane y, u<-x (width),  v<-z (height)   (Hittable.cuh:195-221)
# YZRect: plane x, u<-y (height), v<-z (width)    (Hittable.cuh:251-277)
# NumPy here, converted at use sites: module-level jnp constants would
# initialize the JAX backend at import time, defeating later --cpu /
# jax_platforms configuration.
import numpy as _np

_K_AXIS = _np.array([0, 2, 1, 0], dtype=_np.int32)
_A_AXIS = _np.array([0, 0, 0, 1], dtype=_np.int32)
_B_AXIS = _np.array([0, 1, 2, 2], dtype=_np.int32)
# Extent along the a/b axes expressed as which column of size[N,2] to use:
# for xy/xz rects a=width(0) b=height(1); for yz rects a=height(1) b=width(0).
_A_EXT_COL = _np.array([0, 0, 0, 1], dtype=_np.int32)
_B_EXT_COL = _np.array([0, 1, 1, 0], dtype=_np.int32)

BIG = float(3.4e38)  # FLT_MAX stand-in (Kernel.cu uses FLT_MAX)


class HitRecord(NamedTuple):
    """SoA hit record over a ray batch (reference HitRecord, Hittable.cuh:14-28)."""

    hit: jnp.ndarray  # bool[R]
    t: jnp.ndarray  # f32[R]
    prim: jnp.ndarray  # i32[R] winning primitive index (valid where hit)
    point: jnp.ndarray  # f32[R,3]
    normal: jnp.ndarray  # f32[R,3]
    front_face: jnp.ndarray  # bool[R]
    u: jnp.ndarray  # f32[R]
    v: jnp.ndarray  # f32[R]


def _sphere_block_t(org, dirn, a_quad, center_b, radius_b, t_min, t_max):
    """Candidate hit distance for all rays x a block of spheres.

    org,dirn: [R,3]; center_b: [B,3]; radius_b: [B].
    Returns (hit[R,B], t[R,B]).  The quadratic follows Sphere::Hit
    (Hittable.cuh:80-110): b = oc·d, c = oc·oc - r^2, disc = b^2 - a c,
    roots (-b ∓ sqrt(disc))/a, nearer root preferred.

    oc·d and oc·oc are expanded so the ray-center cross terms become
    [R,3]@[3,B] matmuls, avoiding an [R,B,3] tensor:
        oc·d  = o·d - c·d
        oc·oc = o·o - 2 o·c + c·c
    """
    ct = center_b.T  # [3,B]
    # HIGHEST precision keeps these products in full f32: at the default
    # precision a GPU may run f32 matmuls in TF32 (10-bit mantissa), which
    # destroys the quadratic's discriminant (disc = b*b - a*c cancels) and
    # drops hits — and this scan is the plain reference the BVH path and
    # its kernel are checked against
    o_dot_c = jnp.dot(org, ct, preferred_element_type=jnp.float32,
                      precision=lax.Precision.HIGHEST)  # [R,B]
    d_dot_c = jnp.dot(dirn, ct, preferred_element_type=jnp.float32,
                      precision=lax.Precision.HIGHEST)  # [R,B]
    o_dot_d = dot(org, dirn)[:, None]  # [R,1]
    o_dot_o = dot(org, org)[:, None]  # [R,1]
    c_dot_c = jnp.sum(center_b * center_b, axis=-1)[None, :]  # [1,B]

    b = o_dot_d - d_dot_c  # [R,B]
    c = o_dot_o - 2.0 * o_dot_c + c_dot_c - (radius_b * radius_b)[None, :]
    a = a_quad[:, None]  # [R,1]

    disc = b * b - a * c
    has_root = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t0_ok = (t0 < t_max) & (t0 > t_min)
    t1_ok = (t1 < t_max) & (t1 > t_min)
    t = jnp.where(t0_ok, t0, t1)
    hit = has_root & (t0_ok | t1_ok)
    return hit, t


def _rect_block_t(org, dirn, ptype_b, center_b, size_b, t_min, t_max):
    """Candidate hit distance for all rays x a block of axis-aligned rects.

    Handles xy/xz/yz uniformly via per-primitive axis-index gathers
    (semantics of XYRect/XZRect/YZRect::Hit, Hittable.cuh:128-294).
    Sphere-typed entries produce garbage here; the caller masks them out.
    Returns (hit[R,B], t[R,B]).
    """
    k_ax = jnp.asarray(_K_AXIS)[ptype_b]  # [B]
    a_ax = jnp.asarray(_A_AXIS)[ptype_b]
    b_ax = jnp.asarray(_B_AXIS)[ptype_b]
    ea_col = jnp.asarray(_A_EXT_COL)[ptype_b]  # [B] in {0,1}
    half_a = 0.5 * jnp.where(ea_col == 0, size_b[:, 0], size_b[:, 1])
    half_b = 0.5 * jnp.where(ea_col == 0, size_b[:, 1], size_b[:, 0])

    # per-prim axis selection via one-hot [B,3] masks; ray components are
    # extracted with [R,3]@[3,B] matmuls (at HIGHEST precision: exact
    # selections, no TF32 rounding) instead of [R,B] gathers
    axes3 = jnp.arange(3, dtype=jnp.int32)
    k_oh = (k_ax[:, None] == axes3[None, :]).astype(org.dtype)  # [B,3]
    a_oh = (a_ax[:, None] == axes3[None, :]).astype(org.dtype)
    b_oh = (b_ax[:, None] == axes3[None, :]).astype(org.dtype)

    c_k = jnp.sum(center_b * k_oh, axis=-1)  # [B]
    c_a = jnp.sum(center_b * a_oh, axis=-1)
    c_b = jnp.sum(center_b * b_oh, axis=-1)

    hi = lax.Precision.HIGHEST  # bf16 default would round ray components
    o_k = jnp.dot(org, k_oh.T, preferred_element_type=jnp.float32, precision=hi)
    d_k = jnp.dot(dirn, k_oh.T, preferred_element_type=jnp.float32, precision=hi)
    t = (c_k[None, :] - o_k) / d_k  # [R,B]

    o_a = jnp.dot(org, a_oh.T, preferred_element_type=jnp.float32, precision=hi)
    d_a = jnp.dot(dirn, a_oh.T, preferred_element_type=jnp.float32, precision=hi)
    o_b = jnp.dot(org, b_oh.T, preferred_element_type=jnp.float32, precision=hi)
    d_b = jnp.dot(dirn, b_oh.T, preferred_element_type=jnp.float32, precision=hi)
    p_a = o_a + t * d_a
    p_b = o_b + t * d_b

    in_a = jnp.abs(p_a - c_a[None, :]) <= half_a[None, :]
    in_b = jnp.abs(p_b - c_b[None, :]) <= half_b[None, :]
    hit = (t > t_min) & (t < t_max) & in_a & in_b
    return hit, t


def _tri_block_t(org, dirn, v0_b, e1_b, e2_b, t_min, t_max):
    """Candidate hit distance for all rays x a block of triangles.

    Moller-Trumbore via scalar-triple-product factoring (module docstring):
    four [R,3] @ [3,B] matmuls, no [R,B,3] intermediate.
    org,dirn: [R,3]; v0_b,e1_b,e2_b: [B,3].  Returns (hit[R,B], t[R,B]).
    """
    def cross_b(a, b):  # [B,3] x [B,3]
        return jnp.stack(
            [a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
             a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
             a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=-1)

    n2 = cross_b(e1_b, e2_b)          # [B,3] un-normalized plane normal
    c1 = cross_b(e2_b, v0_b)          # [B,3]
    c2 = cross_b(v0_b, e1_b)          # [B,3]
    s0 = jnp.sum(v0_b * n2, axis=-1)  # [B]
    oxd = jnp.cross(org, dirn)        # [R,3] per-ray moment vector

    hi = lax.Precision.HIGHEST  # bf16 default would destroy the barycentrics
    def mm(a, b):
        return jnp.dot(a, b.T, preferred_element_type=jnp.float32, precision=hi)

    det = -mm(dirn, n2)                      # [R,B]
    t_num = mm(org, n2) - s0[None, :]        # [R,B]
    u_num = mm(oxd, e2_b) - mm(dirn, c1)     # [R,B]
    v_num = -mm(oxd, e1_b) - mm(dirn, c2)    # [R,B]

    ok = jnp.abs(det) > TRI_DET_EPS
    inv = 1.0 / jnp.where(ok, det, 1.0)
    t = t_num * inv
    u = u_num * inv
    v = v_num * inv
    hit = (
        ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < t_max)
    )
    return hit, t


def _moving_sphere_block_t(org, dirn, a_quad, center_b, vel_b, radius_b,
                           time, t_min, t_max):
    """Sphere test with per-path shutter time: effective center =
    c + time * v.  Expanding the quadratic keeps every ray-prim cross
    term an [R,3]@[3,B] matmul:
        oc.d  = o.d - d.c - time (d.v)
        oc.oc = o.o - 2 o.c + c.c + time^2 (v.v) + 2 time (c.v - o.v)
    Zero-velocity rows reduce EXACTLY to the static test (adds exact 0s).
    Returns (hit[R,B], t[R,B])."""
    ct = center_b.T
    vt = vel_b.T
    hi = lax.Precision.HIGHEST
    o_dot_c = jnp.dot(org, ct, preferred_element_type=jnp.float32,
                      precision=hi)
    d_dot_c = jnp.dot(dirn, ct, preferred_element_type=jnp.float32,
                      precision=hi)
    o_dot_v = jnp.dot(org, vt, preferred_element_type=jnp.float32,
                      precision=hi)
    d_dot_v = jnp.dot(dirn, vt, preferred_element_type=jnp.float32,
                      precision=hi)
    o_dot_d = dot(org, dirn)[:, None]
    o_dot_o = dot(org, org)[:, None]
    c_dot_c = jnp.sum(center_b * center_b, axis=-1)[None, :]
    c_dot_v = jnp.sum(center_b * vel_b, axis=-1)[None, :]
    v_dot_v = jnp.sum(vel_b * vel_b, axis=-1)[None, :]
    tm = time[:, None]
    b = o_dot_d - d_dot_c - tm * d_dot_v
    c = (o_dot_o - 2.0 * o_dot_c + c_dot_c
         + tm * tm * v_dot_v + 2.0 * tm * (c_dot_v - o_dot_v)
         - (radius_b * radius_b)[None, :])
    a = a_quad[:, None]
    disc = b * b - a * c
    has_root = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t0_ok = (t0 < t_max) & (t0 > t_min)
    t1_ok = (t1 < t_max) & (t1 > t_min)
    t = jnp.where(t0_ok, t0, t1)
    hit = has_root & (t0_ok | t1_ok)
    return hit, t


def _medium_block_t(org, dirn, a_quad, center_b, radius_b, density_b,
                    u_med, idx_b, t_min, t_max):
    """Stochastic scatter distance inside constant-density sphere media.

    RTOW ConstantMedium::Hit semantics in closed form: both quadratic
    roots bound the interior chord; entry clamps to t_min; the scatter
    point is entry + (-log(u)/density)/|d| and must stay inside the exit.
    ``u_med`` f32[R] is one uniform per ray per wave, decorrelated per
    PRIM by a golden-ratio rotation on the global index (deterministic in
    (ray, prim), so closest-hit stays visit-order independent).
    Returns (hit[R,B], t[R,B])."""
    ct = center_b.T
    hi = lax.Precision.HIGHEST
    o_dot_c = jnp.dot(org, ct, preferred_element_type=jnp.float32,
                      precision=hi)
    d_dot_c = jnp.dot(dirn, ct, preferred_element_type=jnp.float32,
                      precision=hi)
    o_dot_d = dot(org, dirn)[:, None]
    o_dot_o = dot(org, org)[:, None]
    c_dot_c = jnp.sum(center_b * center_b, axis=-1)[None, :]
    b = o_dot_d - d_dot_c
    c = o_dot_o - 2.0 * o_dot_c + c_dot_c - (radius_b * radius_b)[None, :]
    a = a_quad[:, None]
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    te = jnp.maximum(t0, t_min)
    u = u_med[:, None] + idx_b[None, :].astype(jnp.float32) * 0.61803398875
    u = u - jnp.floor(u)
    dlen = jnp.sqrt(jnp.maximum(a_quad, 1e-20))[:, None]
    hit_dist = -jnp.log(jnp.maximum(u, 1e-12)) / density_b[None, :]
    t_c = te + hit_dist / dlen
    hit = (disc > 0.0) & (t1 > te) & (t_c < t1) & (t_c < t_max)
    return hit, t_c


def _medium_box_block_t(org, dirn, a_quad, center_b, he_b, density_b,
                        u_med, idx_b, t_min, t_max, yaw_b=None):
    """Stochastic scatter distance inside constant-density BOX media
    (RTOW book-2 ConstantMedium with a box boundary — the Cornell-smoke
    shape).  The slab test's (t_near, t_far) bound the interior chord;
    entry clamps to t_min; the scatter point is entry +
    (-log(u)/density)/|d| and must stay inside the exit — the exact
    box analog of _medium_block_t (same per-prim golden-ratio
    decorrelation of ``u_med``).  ``yaw_b`` (f32[B], radians) rotates
    each box about world Y through its center (the RTOW
    rotate_y/translate instance transform, RTOW-TNW ch. 8.2): the ray is
    rotated INTO object space before the slab test, and because rotation
    preserves lengths the object-space t values apply to the world ray
    unchanged (the scatter point needs no inverse transform — isotropic
    media have no oriented normal).  ``yaw_b=None`` keeps the historical
    axis-aligned graph bit-identical.  Returns (hit[R,B], t[R,B])."""
    if yaw_b is None:
        inv_d = 1.0 / jnp.where(dirn == 0.0, 1e-30, dirn)  # [R,3]
        bmin = (center_b - he_b)[None, :, :]  # [1,B,3]
        bmax = (center_b + he_b)[None, :, :]
        o = org[:, None, :]  # [R,1,3]
        iv = inv_d[:, None, :]
        t0 = (bmin - o) * iv  # [R,B,3]
        t1 = (bmax - o) * iv
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)  # [R,B]
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    else:
        cy = jnp.cos(yaw_b)[None, :]  # [1,B]
        sy = jnp.sin(yaw_b)[None, :]
        oc = org[:, None, :] - center_b[None, :, :]  # [R,B,3]
        # object-from-world (x_o = c*x - s*z ; z_o = s*x + c*z)
        ox_o = cy * oc[..., 0] - sy * oc[..., 2]
        oy_o = oc[..., 1]
        oz_o = sy * oc[..., 0] + cy * oc[..., 2]
        dx_o = cy * dirn[:, None, 0] - sy * dirn[:, None, 2]
        dy_o = jnp.broadcast_to(dirn[:, None, 1], dx_o.shape)
        dz_o = sy * dirn[:, None, 0] + cy * dirn[:, None, 2]
        o_o = jnp.stack([ox_o, oy_o + jnp.zeros_like(dx_o), oz_o], -1)
        d_o = jnp.stack([dx_o, dy_o, dz_o], -1)  # [R,B,3]
        iv = 1.0 / jnp.where(d_o == 0.0, 1e-30, d_o)
        he = he_b[None, :, :]
        t0 = (-he - o_o) * iv
        t1 = (he - o_o) * iv
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    te = jnp.maximum(tn, t_min)
    u = u_med[:, None] + idx_b[None, :].astype(jnp.float32) * 0.61803398875
    u = u - jnp.floor(u)
    dlen = jnp.sqrt(jnp.maximum(a_quad, 1e-20))[:, None]
    hit_dist = -jnp.log(jnp.maximum(u, 1e-12)) / density_b[None, :]
    t_c = te + hit_dist / dlen
    hit = (tf > te) & (t_c < tf) & (t_c < t_max)
    return hit, t_c


def hit_scene(
    org: jnp.ndarray,
    dirn: jnp.ndarray,
    prim_type: jnp.ndarray,
    center: jnp.ndarray,
    size: jnp.ndarray,
    active: jnp.ndarray,
    t_min: float = 0.001,
    t_max=None,
    block: int = 64,
    edge1: jnp.ndarray | None = None,
    edge2: jnp.ndarray | None = None,
    mat_type: jnp.ndarray | None = None,
    density: jnp.ndarray | None = None,
    u_med: jnp.ndarray | None = None,
    velocity: jnp.ndarray | None = None,
    time: jnp.ndarray | None = None,
    half_ext: jnp.ndarray | None = None,
    yaw: jnp.ndarray | None = None,
):
    """Closest-hit over every active primitive for a ray batch.

    Brute-force analog of HittableList::Hit (Hittable.cuh:532-581), scanned in
    blocks of ``block`` primitives.  Returns (hit[R], t[R], idx[R]).

    ``edge1``/``edge2`` (f32[N,3]) enable the triangle branch; when omitted
    the traced graph is identical to the pre-triangle one (triangle-free
    scenes pay nothing).  ``mat_type``/``density``/``u_med`` enable the
    constant-medium branch (module docstring) the same way.  ``yaw``
    (f32[N], radians; the scene's edge2[:, 0] rows) enables yaw-rotated
    BOX media (the RTOW rotate_y instance transform) — when omitted the
    axis-aligned slab graph is untouched.
    """
    org = jnp.asarray(org)
    dirn = jnp.asarray(dirn)
    prim_type = jnp.asarray(prim_type)
    center = jnp.asarray(center)
    size = jnp.asarray(size)
    active = jnp.asarray(active)
    with_tris = edge1 is not None
    if with_tris:
        edge1 = jnp.asarray(edge1)
        edge2 = jnp.asarray(edge2)
    with_media = u_med is not None and mat_type is not None
    if with_media:
        mat_type = jnp.asarray(mat_type)
        density = jnp.asarray(density)
        u_med = jnp.asarray(u_med)
    with_motion = velocity is not None and time is not None
    if with_motion:
        velocity = jnp.asarray(velocity)
        time = jnp.asarray(time)
    # box-bounded media (prim BOX + mat ISOTROPIC): half-extents ride the
    # scene's edge1 rows — only threaded when the caller has box media
    with_boxm = with_media and half_ext is not None
    if with_boxm:
        half_ext = jnp.asarray(half_ext)
    with_rotm = with_boxm and yaw is not None
    if with_rotm:
        yaw = jnp.asarray(yaw)
    n = prim_type.shape[0]
    r = org.shape[0]
    if t_max is None:
        t_max = BIG
    t_max = jnp.asarray(t_max, jnp.float32)

    pad = (-n) % block
    if pad:
        prim_type = jnp.pad(prim_type, (0, pad))
        center = jnp.pad(center, ((0, pad), (0, 0)))
        size = jnp.pad(size, ((0, pad), (0, 0)), constant_values=1.0)
        active = jnp.pad(active, (0, pad))
        if with_tris:
            edge1 = jnp.pad(edge1, ((0, pad), (0, 0)))
            edge2 = jnp.pad(edge2, ((0, pad), (0, 0)))
        if with_media:
            mat_type = jnp.pad(mat_type, (0, pad))
            density = jnp.pad(density, (0, pad), constant_values=1.0)
        if with_motion:
            velocity = jnp.pad(velocity, ((0, pad), (0, 0)))
        if with_boxm:
            half_ext = jnp.pad(half_ext, ((0, pad), (0, 0)))
        if with_rotm:
            yaw = jnp.pad(yaw, (0, pad))
    n_pad = n + pad
    nblocks = n_pad // block

    a_quad = dot(dirn, dirn)  # [R]

    pt_blocks = prim_type.reshape(nblocks, block)
    c_blocks = center.reshape(nblocks, block, 3)
    s_blocks = size.reshape(nblocks, block, 2)
    act_blocks = active.reshape(nblocks, block)
    scan_blocks = (pt_blocks, c_blocks, s_blocks, act_blocks)
    if with_tris:
        scan_blocks = scan_blocks + (
            edge1.reshape(nblocks, block, 3),
            edge2.reshape(nblocks, block, 3),
        )
    if with_media:
        scan_blocks = scan_blocks + (
            mat_type.reshape(nblocks, block),
            density.reshape(nblocks, block),
        )
    if with_boxm:
        scan_blocks = scan_blocks + (half_ext.reshape(nblocks, block, 3),)
    if with_rotm:
        scan_blocks = scan_blocks + (yaw.reshape(nblocks, block),)
    if with_motion:
        scan_blocks = scan_blocks + (velocity.reshape(nblocks, block, 3),)

    def body(carry, blk):
        best_t, best_idx = carry
        ptype_b, center_b, size_b, act_b, *rest_b, base = blk
        if with_motion:
            vel_b = rest_b[-1]
            rest_b = rest_b[:-1]
        if with_rotm:
            yaw_b = rest_b[-1]
            rest_b = rest_b[:-1]
        if with_boxm:
            he_b = rest_b[-1]
            rest_b = rest_b[:-1]
        if with_media:
            mat_b, dens_b = rest_b[-2], rest_b[-1]
            edges_b = rest_b[:-2]
        else:
            edges_b = rest_b

        is_sphere = ptype_b == SPHERE
        if with_motion:
            sph_hit, sph_t = _moving_sphere_block_t(
                org, dirn, a_quad, center_b, vel_b, size_b[:, 0],
                time, t_min, t_max
            )
        else:
            sph_hit, sph_t = _sphere_block_t(
                org, dirn, a_quad, center_b, size_b[:, 0], t_min, t_max
            )
        rect_hit, rect_t = _rect_block_t(
            org, dirn, jnp.clip(ptype_b, 0, YZ_RECT), center_b, size_b,
            t_min, t_max
        )
        hit = jnp.where(is_sphere[None, :], sph_hit, rect_hit)
        t = jnp.where(is_sphere[None, :], sph_t, rect_t)
        if with_tris:
            is_tri = ptype_b == TRIANGLE
            tri_hit, tri_t = _tri_block_t(
                org, dirn, center_b, edges_b[0], edges_b[1], t_min, t_max
            )
            hit = jnp.where(is_tri[None, :], tri_hit, hit)
            t = jnp.where(is_tri[None, :], tri_t, t)
        if with_media:
            is_med = is_sphere & (mat_b == 4)  # materials.ISOTROPIC
            med_hit, med_t = _medium_block_t(
                org, dirn, a_quad, center_b, size_b[:, 0], dens_b,
                u_med, base + jnp.arange(block, dtype=jnp.int32),
                t_min, t_max,
            )
            hit = jnp.where(is_med[None, :], med_hit, hit)
            t = jnp.where(is_med[None, :], med_t, t)
            if with_boxm:
                is_boxm = (ptype_b == BOX) & (mat_b == 4)
                boxm_hit, boxm_t = _medium_box_block_t(
                    org, dirn, a_quad, center_b, he_b, dens_b, u_med,
                    base + jnp.arange(block, dtype=jnp.int32),
                    t_min, t_max,
                    yaw_b=yaw_b if with_rotm else None,
                )
                hit = jnp.where(is_boxm[None, :], boxm_hit, hit)
                t = jnp.where(is_boxm[None, :], boxm_t, t)
        hit = hit & act_b[None, :]
        t = jnp.where(hit, t, jnp.float32(BIG))

        blk_t = jnp.min(t, axis=1)  # [R]
        blk_arg = jnp.argmin(t, axis=1).astype(jnp.int32) + base

        closer = blk_t < best_t
        best_t = jnp.where(closer, blk_t, best_t)
        best_idx = jnp.where(closer, blk_arg, best_idx)
        return (best_t, best_idx), None

    # derive the init from the ray arrays so it inherits any mesh-varying
    # axes when running inside shard_map
    init = (
        jnp.full_like(org[:, 0], BIG),
        jnp.full_like(org[:, 0], -1, dtype=jnp.int32),
    )
    bases = jnp.arange(nblocks, dtype=jnp.int32) * block
    (best_t, best_idx), _ = lax.scan(
        body, init, scan_blocks + (bases,)
    )
    # A hit must also beat the caller's t_max budget.
    hit = (best_idx >= 0) & (best_t < t_max)
    return hit, best_t, best_idx


def make_hit_record(
    org: jnp.ndarray,
    dirn: jnp.ndarray,
    hit: jnp.ndarray,
    t: jnp.ndarray,
    idx: jnp.ndarray,
    prim_type: jnp.ndarray,
    center: jnp.ndarray,
    size: jnp.ndarray,
    edge1: jnp.ndarray | None = None,
    edge2: jnp.ndarray | None = None,
    uv0: jnp.ndarray | None = None,
    uv1: jnp.ndarray | None = None,
    uv2: jnp.ndarray | None = None,
    vnorm0: jnp.ndarray | None = None,
    vnorm1: jnp.ndarray | None = None,
    vnorm2: jnp.ndarray | None = None,
    mat_type: jnp.ndarray | None = None,
    velocity: jnp.ndarray | None = None,
    time: jnp.ndarray | None = None,
) -> HitRecord:
    """Reconstruct normal / uv / front_face for each ray's winning primitive.

    Sphere branch follows Sphere::Hit + GetSphereUV (Hittable.cuh:90-125):
    the sphere normal is the raw outward (p - c)/r WITHOUT face flipping;
    the dielectric handles inside hits by sign tests, exactly as the
    reference does.  Rect branches apply SetFaceNormal (Hittable.cuh:20-27).
    Triangles (beyond-reference) are two-sided like rects: outward normal
    normalize(e1 x e2), SetFaceNormal flip, barycentric (u, v).

    Per-vertex attributes (beyond-reference, optional — pass all of
    ``uv0..uv2`` and/or all of ``vnorm0..vnorm2``, f32[N,2]/f32[N,3]):
      * texcoords: the record's (u, v) becomes the barycentric
        interpolation uv0 + u*(uv1-uv0) + v*(uv2-uv0) — with the default
        (0,0)/(1,0)/(0,1) rows this is exactly the raw barycentrics.
      * smooth shading: the normal becomes the normalized interpolation of
        the vertex normals, flipped to the geometric front side
        (front_face itself stays geometric so dielectric sign logic is
        unchanged).  All-zero vnorm rows mean "flat": face normal.
    """
    org = jnp.asarray(org)
    dirn = jnp.asarray(dirn)
    prim_type = jnp.asarray(prim_type)
    center = jnp.asarray(center)
    size = jnp.asarray(size)
    safe_idx = jnp.maximum(jnp.asarray(idx), 0)
    ptype = prim_type[safe_idx]  # [R]
    c = center[safe_idx]  # [R,3]
    if velocity is not None and time is not None:
        # moving spheres: the winner's center at the path's shutter time
        c = c + jnp.asarray(time)[:, None] * jnp.asarray(velocity)[safe_idx]
    sz = size[safe_idx]  # [R,2]

    point = org + t[:, None] * dirn  # [R,3]

    # --- sphere branch ---
    radius = sz[:, 0]
    sph_normal = (point - c) / radius[:, None]
    theta = jnp.arccos(jnp.clip(-sph_normal[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(-sph_normal[:, 2], sph_normal[:, 0]) + PI
    sph_u = phi / (2.0 * PI)
    sph_v = theta / PI
    sph_front = dot(dirn, sph_normal) < 0.0

    # --- rect branch (vectorized across the 3 rect types) ---
    # Per-ray axis selection is done with one-hot masks + multiply-sum
    # instead of [R]-indexed fancy gathers: a handful of fused
    # elementwise ops.
    rtype = jnp.clip(ptype, 0, YZ_RECT)  # triangle rows masked out below
    k_ax = jnp.asarray(_K_AXIS)[rtype]
    a_ax = jnp.asarray(_A_AXIS)[rtype]
    b_ax = jnp.asarray(_B_AXIS)[rtype]
    axes3 = jnp.arange(3, dtype=jnp.int32)
    a_oh = (a_ax[:, None] == axes3[None, :]).astype(org.dtype)  # [R,3]
    b_oh = (b_ax[:, None] == axes3[None, :]).astype(org.dtype)
    k_oh = (k_ax[:, None] == axes3[None, :]).astype(org.dtype)
    ea_col = jnp.asarray(_A_EXT_COL)[rtype]  # [R] in {0,1}
    ext_a = jnp.where(ea_col == 0, sz[:, 0], sz[:, 1])
    ext_b = jnp.where(ea_col == 0, sz[:, 1], sz[:, 0])
    p_a = jnp.sum(point * a_oh, axis=-1)
    p_b = jnp.sum(point * b_oh, axis=-1)
    c_a = jnp.sum(c * a_oh, axis=-1)
    c_b = jnp.sum(c * b_oh, axis=-1)
    rect_u = (p_a - (c_a - 0.5 * ext_a)) / jnp.maximum(ext_a, 1e-12)
    rect_v = (p_b - (c_b - 0.5 * ext_b)) / jnp.maximum(ext_b, 1e-12)
    outward = k_oh
    rect_front = dot(dirn, outward) < 0.0
    rect_normal = jnp.where(rect_front[:, None], outward, -outward)

    is_sphere = ptype == SPHERE
    normal = jnp.where(is_sphere[:, None], sph_normal, rect_normal)
    front = jnp.where(is_sphere, sph_front, rect_front)
    u = jnp.where(is_sphere, sph_u, rect_u)
    v = jnp.where(is_sphere, sph_v, rect_v)

    if edge1 is not None:
        # --- triangle branch (beyond-reference) ---
        e1 = jnp.asarray(edge1)[safe_idx]  # [R,3]
        e2 = jnp.asarray(edge2)[safe_idx]
        n2 = jnp.cross(e1, e2)
        tri_out = n2 / jnp.maximum(
            jnp.linalg.norm(n2, axis=-1, keepdims=True), 1e-20)
        tri_front = dot(dirn, tri_out) < 0.0
        tri_normal = jnp.where(tri_front[:, None], tri_out, -tri_out)
        # barycentric (u, v) of the hit point: standard basis projection
        w = point - c  # c = v0 for triangles
        d00 = dot(e1, e1)
        d01 = dot(e1, e2)
        d11 = dot(e2, e2)
        dw1 = dot(w, e1)
        dw2 = dot(w, e2)
        den = jnp.maximum(d00 * d11 - d01 * d01, 1e-20)
        tri_u = (d11 * dw1 - d01 * dw2) / den
        tri_v = (d00 * dw2 - d01 * dw1) / den

        tri_u_out, tri_v_out = tri_u, tri_v
        if uv0 is not None:
            # interpolated texcoords (module docstring); with the default
            # rows this reduces to (tri_u, tri_v) exactly
            a0 = jnp.asarray(uv0)[safe_idx]  # [R,2]
            a1 = jnp.asarray(uv1)[safe_idx]
            a2 = jnp.asarray(uv2)[safe_idx]
            uvi = a0 + tri_u[:, None] * (a1 - a0) + tri_v[:, None] * (a2 - a0)
            tri_u_out, tri_v_out = uvi[:, 0], uvi[:, 1]

        if vnorm0 is not None:
            n0 = jnp.asarray(vnorm0)[safe_idx]  # [R,3]
            n1v = jnp.asarray(vnorm1)[safe_idx]
            n2v = jnp.asarray(vnorm2)[safe_idx]
            ni = n0 + tri_u[:, None] * (n1v - n0) + tri_v[:, None] * (n2v - n0)
            nlen = jnp.linalg.norm(ni, axis=-1, keepdims=True)
            # all-zero rows (flat triangle) or degenerate interpolation
            # fall back to the face normal
            has_vn = nlen[:, 0] > 1e-8
            ni = ni / jnp.maximum(nlen, 1e-20)
            ni = jnp.where(tri_front[:, None], ni, -ni)
            tri_normal = jnp.where(has_vn[:, None], ni, tri_normal)

        is_tri = ptype == TRIANGLE
        normal = jnp.where(is_tri[:, None], tri_normal, normal)
        front = jnp.where(is_tri, tri_front, front)
        u = jnp.where(is_tri, tri_u_out, u)
        v = jnp.where(is_tri, tri_v_out, v)

    if mat_type is not None:
        # constant-medium winners: arbitrary unit normal + front_face,
        # exactly like RTOW ConstantMedium::Hit (the isotropic phase
        # function ignores both); (u, v) = 0 so constant/checker/noise
        # textures (which use the 3D point) behave and image uvs are
        # defined
        is_med = jnp.asarray(mat_type)[safe_idx] == 4  # ISOTROPIC
        med_n = jnp.zeros_like(normal).at[:, 0].set(1.0)
        normal = jnp.where(is_med[:, None], med_n, normal)
        front = jnp.where(is_med, True, front)
        u = jnp.where(is_med, 0.0, u)
        v = jnp.where(is_med, 0.0, v)

    return HitRecord(
        hit=hit,
        t=t,
        prim=idx,
        point=point,
        normal=normal,
        front_face=front,
        u=u,
        v=v,
    )
