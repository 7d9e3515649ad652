"""Closest-hit BVH traversal as one GPU kernel (Pallas, Triton route).

The XLA traversal (ops/bvh_traverse.py::bvh_closest_hit) advances the
whole ray wavefront one node per ``while_loop`` step: every step gathers
``[R]``-wide node data from device memory, writes the per-ray state back,
and the loop runs until the slowest ray of the frame is done.  This kernel
is the reference's per-thread traversal shape instead (reference:
CudaRayTracer/src/Hittables/Hittable.cuh:387-439): one program owns a block
of rays, each lane keeps its node index, best ``t`` and best primitive in
registers, and the block walks the same stackless skip-link tree until its
own rays are done.  The node and primitive tables are small and stay in L2.

Results match ``bvh_closest_hit`` up to float evaluation order (FMA
contraction), so hit index and ``t`` agree on all but ray-primitive ties.
Media and moving spheres stay outside the tree, exactly as there
(models/bvh.py::make_bvh_hit_fn runs their side pass in XLA).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import BIG, SPHERE, TRIANGLE, TRI_DET_EPS, XY_RECT, XZ_RECT

# rays per program and warps per program: one warp of 32 rays was the
# fastest end to end on rtow_final 1280x720 depth 12 on an H100 (12.1 ms
# vs 13.3 ms/frame at 128 rays / 4 warps; PERF.md)
BLOCK_RAYS = 32
NUM_WARPS = 1

# node table columns: min xyz, max xyz (f32); prim, skip (i32)
_NODE_F = 6
_NODE_I = 2
# primitive table columns: center xyz, size (2), and with triangles
# edge1 xyz, edge2 xyz
_PRIM_F_TRI = 11


def _kernel(n_ref, ray_ref, node_f_ref, node_i_ref, ptype_ref, prim_f_ref,
            t_ref, prim_ref, *, t_min: float, prim_cols: int):
    has_tris = prim_cols == _PRIM_F_TRI
    ox, oy, oz = ray_ref[0, :], ray_ref[1, :], ray_ref[2, :]
    dx, dy, dz = ray_ref[3, :], ray_ref[4, :], ray_ref[5, :]
    # aabb.inv_direction: sign-preserving stand-in for 1/0
    ix = jnp.where(dx == 0.0, jnp.float32(1e30), 1.0 / dx)
    iy = jnp.where(dy == 0.0, jnp.float32(1e30), 1.0 / dy)
    iz = jnp.where(dz == 0.0, jnp.float32(1e30), 1.0 / dz)
    a_quad = dx * dx + dy * dy + dz * dz
    od = ox * dx + oy * dy + oz * dz
    n_nodes = n_ref[0]

    def gather(ref, idx, col, ncol, mask):
        return plgpu.load(ref.at[idx * ncol + col], mask=mask, other=0)

    def cond(carry):
        idx, _, _, steps = carry
        return (jnp.max(idx) >= 0) & (steps < n_nodes + 1)

    def body(carry):
        idx, best_t, best_prim, steps = carry
        live = idx >= 0
        safe = jnp.maximum(idx, 0)
        nf = [gather(node_f_ref, safe, c, _NODE_F, live)
              for c in range(_NODE_F)]
        prim = gather(node_i_ref, safe, 0, _NODE_I, live)
        skip = gather(node_i_ref, safe, 1, _NODE_I, live)

        # aabb.aabb_hit against the current closest hit
        tx0, tx1 = (nf[0] - ox) * ix, (nf[3] - ox) * ix
        ty0, ty1 = (nf[1] - oy) * iy, (nf[4] - oy) * iy
        tz0, tz1 = (nf[2] - oz) * iz, (nf[5] - oz) * iz
        near = jnp.maximum(jnp.maximum(jnp.minimum(tx0, tx1),
                                       jnp.minimum(ty0, ty1)),
                           jnp.minimum(tz0, tz1))
        far = jnp.minimum(jnp.minimum(jnp.maximum(tx0, tx1),
                                      jnp.maximum(ty0, ty1)),
                          jnp.maximum(tz0, tz1))
        box_hit = (jnp.minimum(far, best_t) > jnp.maximum(near, t_min)) & live

        is_leaf = prim >= 0
        test = box_hit & is_leaf
        psafe = jnp.maximum(prim, 0)
        ptype = plgpu.load(ptype_ref.at[psafe], mask=test, other=-1)
        pf = [gather(prim_f_ref, psafe, c, prim_cols, test)
              for c in range(prim_cols)]
        cx, cy, cz, s0, s1 = pf[:5]

        # sphere (bvh_traverse._leaf_prim_t)
        oc_b = od - (cx * dx + cy * dy + cz * dz)
        qx, qy, qz = ox - cx, oy - cy, oz - cz
        oc_c = (qx * qx + qy * qy + qz * qz) - s0 * s0
        disc = oc_b * oc_b - a_quad * oc_c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0 = (-oc_b - sq) / a_quad
        t1 = (-oc_b + sq) / a_quad
        t0_ok = (t0 < best_t) & (t0 > t_min)
        t1_ok = (t1 < best_t) & (t1 > t_min)
        sph_t = jnp.where(t0_ok, t0, t1)
        sph_hit = (disc > 0.0) & (t0_ok | t1_ok)

        # rect: plane axis k, in-plane axes a, b (intersect._K/_A/_B_AXIS)
        xy, xz = ptype == XY_RECT, ptype == XZ_RECT
        o_k = jnp.where(xy, oz, jnp.where(xz, oy, ox))
        d_k = jnp.where(xy, dz, jnp.where(xz, dy, dx))
        c_k = jnp.where(xy, cz, jnp.where(xz, cy, cx))
        o_a = jnp.where(xy | xz, ox, oy)
        d_a = jnp.where(xy | xz, dx, dy)
        c_a = jnp.where(xy | xz, cx, cy)
        o_b = jnp.where(xy, oy, oz)
        d_b = jnp.where(xy, dy, dz)
        c_b = jnp.where(xy, cy, cz)
        yz = ~(xy | xz)
        half_a = 0.5 * jnp.where(yz, s1, s0)
        half_b = 0.5 * jnp.where(yz, s0, s1)
        rt = (c_k - o_k) / d_k
        in_a = jnp.abs((o_a + rt * d_a) - c_a) <= half_a
        in_b = jnp.abs((o_b + rt * d_b) - c_b) <= half_b
        rect_hit = (rt > t_min) & (rt < best_t) & in_a & in_b

        is_sphere = ptype == SPHERE
        p_hit = jnp.where(is_sphere, sph_hit, rect_hit)
        p_t = jnp.where(is_sphere, sph_t, rt)

        if has_tris:
            # Moller-Trumbore (center = v0)
            e1x, e1y, e1z, e2x, e2y, e2z = pf[5:]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = jnp.abs(det) > TRI_DET_EPS
            inv = 1.0 / jnp.where(ok, det, 1.0)
            u = (qx * px + qy * py + qz * pz) * inv
            vx = qy * e1z - qz * e1y
            vy = qz * e1x - qx * e1z
            vz = qx * e1y - qy * e1x
            v = (dx * vx + dy * vy + dz * vz) * inv
            tri_t = (e2x * vx + e2y * vy + e2z * vz) * inv
            tri_hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                       & (tri_t > t_min) & (tri_t < best_t))
            is_tri = ptype == TRIANGLE
            p_hit = jnp.where(is_tri, tri_hit, p_hit)
            p_t = jnp.where(is_tri, tri_t, p_t)

        win = test & p_hit & (p_t < best_t)
        best_t = jnp.where(win, p_t, best_t)
        best_prim = jnp.where(win, prim, best_prim)
        # interior hit -> descend (idx+1); leaf or miss -> follow skip link
        nxt = jnp.where(box_hit & ~is_leaf, idx + 1, skip)
        return jnp.where(live, nxt, idx), best_t, best_prim, steps + 1

    root = jnp.minimum(n_nodes, 1) - 1  # 0, or -1 for an empty tree
    init = (jnp.zeros_like(ox, dtype=jnp.int32) + root,
            jnp.full_like(ox, BIG),
            jnp.full_like(ox, -1, dtype=jnp.int32),
            jnp.int32(0))
    _, best_t, best_prim, _ = lax.while_loop(cond, body, init)
    t_ref[...] = best_t
    prim_ref[...] = best_prim


class KernelTables(NamedTuple):
    """The kernel's flat copies of the tree and the primitives
    (pack_tables).  make_bvh_hit_fn packs them once per frame, outside the
    bounce loop; each bounce then packs only its rays."""

    n_nodes: jax.Array    # i32[1]
    node_f: jax.Array     # f32[N * 6]: min xyz, max xyz per node
    node_i: jax.Array     # i32[N * 2]: prim, skip per node
    prim_type: jax.Array  # i32[P]
    prim_f: jax.Array     # f32[P, 5]: center xyz, size (2); f32[P, 11]
    #                       with triangles: ... edge1 xyz, edge2 xyz


def pack_tables(bvh, prim_type, center, size, edge1=None,
                edge2=None) -> KernelTables:
    """Interleave ``bvh`` (models.bvh.BVHData) and the scene's primitive
    arrays into the tables the kernel gathers from."""
    cols = [center, size] + ([edge1, edge2] if edge1 is not None else [])
    return KernelTables(
        n_nodes=jnp.reshape(bvh.n_nodes, (1,)).astype(jnp.int32),
        node_f=jnp.concatenate([bvh.node_min, bvh.node_max],
                               axis=1).reshape(-1),
        node_i=jnp.stack([bvh.node_prim, bvh.node_skip], axis=1).reshape(-1),
        prim_type=prim_type.astype(jnp.int32),
        prim_f=jnp.concatenate(cols, axis=1),
    )


@functools.partial(jax.jit, static_argnames=("t_min", "interpret"))
def bvh_closest_hit_kernel(org, dirn, tables: KernelTables,
                           t_min: float = 0.001, *, interpret: bool = False):
    """Closest hit of every ray through the flat BVH, on the GPU.

    Same contract as ``bvh_traverse.bvh_closest_hit`` with ``t_max=None``:
    returns (hit[R], t[R], prim_idx[R]).  ``tables`` come from
    pack_tables.  Rays are padded to a multiple of BLOCK_RAYS;
    ``interpret=True`` runs the kernel on the CPU.
    """
    r = org.shape[0]
    rp = -(-r // BLOCK_RAYS) * BLOCK_RAYS
    prim_cols = tables.prim_f.shape[1]
    # [8, R] rows: origin xyz, direction xyz, two zero rows (a Triton
    # block's dimensions are powers of two)
    rays = jnp.concatenate(
        [org.T, dirn.T, jnp.zeros((2, r), jnp.float32)], axis=0)
    # padding lanes get a unit direction so they stay finite
    rays = jnp.pad(rays, ((0, 0), (0, rp - r)))
    if rp > r:
        rays = rays.at[3, r:].set(1.0)

    whole = lambda x: pl.BlockSpec(x.shape, lambda i: (0,) * x.ndim)
    ins = (tables.n_nodes, rays, tables.node_f, tables.node_i,
           tables.prim_type, tables.prim_f.reshape(-1))
    t, prim = pl.pallas_call(
        functools.partial(_kernel, t_min=float(t_min), prim_cols=prim_cols),
        out_shape=(jax.ShapeDtypeStruct((rp,), jnp.float32),
                   jax.ShapeDtypeStruct((rp,), jnp.int32)),
        grid=(rp // BLOCK_RAYS,),
        in_specs=[whole(ins[0]),
                  pl.BlockSpec((8, BLOCK_RAYS), lambda i: (0, i)),
                  *(whole(x) for x in ins[2:])],
        out_specs=(pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,)),
                   pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh_closest_hit",
    )(*ins)
    t, prim = t[:r], prim[:r]
    return prim >= 0, t, prim
