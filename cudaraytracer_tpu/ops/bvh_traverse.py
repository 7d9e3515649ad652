"""Stackless skip-link BVH traversal, vectorized over the ray wavefront.

The plain XLA version of the reference's per-thread explicit-stack
traversal (reference: CudaRayTracer/src/Hittables/Hittable.cuh:387-439,
which uses a register-pressure-limited 16-entry stack — a hard scene-size
limit).  Every ray carries a single node index; DFS-flattened nodes make
the hit-path successor ``idx+1`` and a precomputed ``skip`` link the
miss-path successor, so there is no stack at all and no depth limit.  The
whole wavefront advances in lock-step inside one ``lax.while_loop`` until
every lane reaches the -1 sentinel; lanes that finish early are masked.
It is the reference the GPU closest-hit kernel (ops/bvh_kernel.py) is
tested against, and the traversal on the CPU.

Leaf handling inlines a single-primitive intersection test (the analog of
PerformHit's type switch, Hittable.cuh:470-485) computed branch-free for
sphere + rect and masked by the leaf's type.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .aabb import aabb_hit, inv_direction
from .intersect import (
    _A_AXIS, _A_EXT_COL, _B_AXIS, _K_AXIS, BIG, SPHERE, TRIANGLE,
    TRI_DET_EPS,
)
from ..utils.vec import dot


def _leaf_prim_t(org, dirn, a_quad, ptype, center, size, t_min, t_max,
                 e1=None, e2=None):
    """Hit distance of each ray against ITS OWN leaf primitive.

    All inputs per-ray: ptype[R], center[R,3], size[R,2].  Both the sphere
    quadratic (Hittable.cuh:80-110) and the generic rect test
    (Hittable.cuh:128-294) are evaluated and selected by type; per-ray
    triangle edges ``e1``/``e2`` [R,3] add the Moller-Trumbore branch
    (direct form — per-ray data, so no matmul factoring needed here).
    Returns (hit[R], t[R]).
    """
    # ---- sphere ----
    oc_b = dot(org, dirn) - dot(center, dirn)  # oc·d
    oc_c = dot(org - center, org - center) - size[:, 0] * size[:, 0]
    disc = oc_b * oc_b - a_quad * oc_c
    has_root = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = (-oc_b - sq) / a_quad
    t1 = (-oc_b + sq) / a_quad
    t0_ok = (t0 < t_max) & (t0 > t_min)
    t1_ok = (t1 < t_max) & (t1 > t_min)
    sph_t = jnp.where(t0_ok, t0, t1)
    sph_hit = has_root & (t0_ok | t1_ok)

    # ---- rect (any orientation) ----
    # one-hot multiply-sum selects the rect axes (bvh_kernel.py selects
    # the same components with jnp.where)
    rtype = jnp.clip(ptype, 0, 3)  # triangle rows masked out below
    k_ax = jnp.asarray(_K_AXIS)[rtype]
    a_ax = jnp.asarray(_A_AXIS)[rtype]
    b_ax = jnp.asarray(_B_AXIS)[rtype]
    axes3 = jnp.arange(3, dtype=jnp.int32)
    k_oh = (k_ax[:, None] == axes3[None, :]).astype(org.dtype)  # [R,3]
    a_oh = (a_ax[:, None] == axes3[None, :]).astype(org.dtype)
    b_oh = (b_ax[:, None] == axes3[None, :]).astype(org.dtype)
    ea_col = jnp.asarray(_A_EXT_COL)[rtype]
    half_a = 0.5 * jnp.where(ea_col == 0, size[:, 0], size[:, 1])
    half_b = 0.5 * jnp.where(ea_col == 0, size[:, 1], size[:, 0])
    o_k = jnp.sum(org * k_oh, axis=-1)
    d_k = jnp.sum(dirn * k_oh, axis=-1)
    c_k = jnp.sum(center * k_oh, axis=-1)
    t = (c_k - o_k) / d_k
    p_a = jnp.sum(org * a_oh, axis=-1) + t * jnp.sum(dirn * a_oh, axis=-1)
    p_b = jnp.sum(org * b_oh, axis=-1) + t * jnp.sum(dirn * b_oh, axis=-1)
    in_a = jnp.abs(p_a - jnp.sum(center * a_oh, axis=-1)) <= half_a
    in_b = jnp.abs(p_b - jnp.sum(center * b_oh, axis=-1)) <= half_b
    rect_hit = (t > t_min) & (t < t_max) & in_a & in_b

    is_sphere = ptype == SPHERE
    hit = jnp.where(is_sphere, sph_hit, rect_hit)
    tt = jnp.where(is_sphere, sph_t, t)

    if e1 is not None:
        # ---- triangle (beyond-reference; Moller-Trumbore, direct form) ----
        pv = jnp.cross(dirn, e2)
        det = jnp.sum(e1 * pv, axis=-1)
        ok = jnp.abs(det) > TRI_DET_EPS
        inv = 1.0 / jnp.where(ok, det, 1.0)
        tv = org - center  # center = v0 for triangles
        u = jnp.sum(tv * pv, axis=-1) * inv
        qv = jnp.cross(tv, e1)
        v = jnp.sum(dirn * qv, axis=-1) * inv
        tri_t = jnp.sum(e2 * qv, axis=-1) * inv
        tri_hit = (
            ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (tri_t > t_min) & (tri_t < t_max)
        )
        is_tri = ptype == TRIANGLE
        hit = jnp.where(is_tri, tri_hit, hit)
        tt = jnp.where(is_tri, tri_t, tt)
    return hit, tt


def bvh_closest_hit(
    org: jnp.ndarray,
    dirn: jnp.ndarray,
    bvh,
    prim_type: jnp.ndarray,
    center: jnp.ndarray,
    size: jnp.ndarray,
    t_min: float = 0.001,
    t_max=None,
    edge1: jnp.ndarray | None = None,
    edge2: jnp.ndarray | None = None,
):
    """Closest-hit via the flat BVH.  Same contract as intersect.hit_scene:
    returns (hit[R], t[R], prim_idx[R])."""
    org = jnp.asarray(org)
    dirn = jnp.asarray(dirn)
    if t_max is None:
        t_max = jnp.float32(BIG)
    inv_d = inv_direction(dirn)
    a_quad = dot(dirn, dirn)
    r = org.shape[0]
    # safety bound: a DFS visit never exceeds node count (plus margin for
    # the empty-scene case where n_nodes == 0)
    max_steps = bvh.n_nodes + 1

    def cond(carry):
        idx, best_t, best_prim, steps = carry
        return jnp.any(idx >= 0) & (steps < max_steps)

    def body(carry):
        idx, best_t, best_prim, steps = carry
        live = idx >= 0
        safe = jnp.maximum(idx, 0)
        bmin = bvh.node_min[safe]  # [R,3]
        bmax = bvh.node_max[safe]
        prim = bvh.node_prim[safe]  # [R]
        skip = bvh.node_skip[safe]

        box_hit = aabb_hit(org, inv_d, bmin, bmax, t_min, best_t) & live

        is_leaf = prim >= 0
        test = box_hit & is_leaf
        psafe = jnp.maximum(prim, 0)
        p_hit, p_t = _leaf_prim_t(
            org, dirn, a_quad,
            prim_type[psafe], center[psafe], size[psafe],
            t_min, jnp.minimum(best_t, t_max),
            e1=None if edge1 is None else edge1[psafe],
            e2=None if edge2 is None else edge2[psafe],
        )
        win = test & p_hit & (p_t < best_t)
        best_t = jnp.where(win, p_t, best_t)
        best_prim = jnp.where(win, prim, best_prim)

        # interior hit -> descend (idx+1); leaf or miss -> follow skip link
        nxt = jnp.where(box_hit & ~is_leaf, idx + 1, skip)
        idx = jnp.where(live, nxt, idx)
        return idx, best_t, best_prim, steps + 1

    # start at the root ONLY if the tree is non-empty
    root = jnp.where(bvh.n_nodes > 0, 0, -1)
    init = (
        jnp.full_like(org[:, 0], 1, dtype=jnp.int32) * root,
        jnp.full_like(org[:, 0], jnp.float32(BIG)),
        jnp.full_like(org[:, 0], -1, dtype=jnp.int32),
        jnp.zeros_like(org[0, 0], dtype=jnp.int32),
    )
    _, best_t, best_prim, _ = lax.while_loop(cond, body, init)
    hit = (best_prim >= 0) & (best_t < t_max)
    return hit, best_t, best_prim
