"""Host-side BVH builder producing flat skip-link arrays.

Re-architecture of the reference BVHNode (reference:
CudaRayTracer/src/Hittables/Hittable.cuh:303-465):

  * The reference builds a pointer tree of managed-memory slabs on the host,
    sorting primitives BY TYPE (thrust::sort with HittableTypeComparator —
    not spatial! Hittable.cuh:311-320) and traverses with an explicit
    16-entry stack per CUDA thread (Hittable.cuh:387-439), a hard
    scene-size limit.
  * Here the host builds (NumPy, or the C++ native builder when present) a
    proper spatial tree — median split on the longest centroid axis, or
    binned SAH — and flattens it in DFS order into four device arrays:
    node_min/node_max (AABBs), node_prim (leaf primitive id or -1) and
    node_skip (where to jump on AABB miss).  DFS order makes the hit-path
    successor just ``idx+1``, so traversal is STACKLESS: each ray carries a
    single node index, which vectorizes across the whole wavefront (no
    per-lane stacks, no depth limit).
  * Arrays are padded to a fixed capacity so the per-edit rebuild
    (reference rebuilds the BVH on every geometry drag, CudaLayer.cpp:
    491-556) re-uploads kilobytes without recompiling the renderer.

AABB construction per primitive matches the reference BoundingBox methods:
sphere = center +/- r (Hittable.cuh:112-116); rects get +/-1e-4 slabs on
their plane axis (Hittable.cuh:167-181, 223-237, 279-293).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .scene import Scene

RECT_PAD = 1e-4
_K_AXIS = {1: 2, 2: 1, 3: 0}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVHData:
    """Flat skip-link BVH on device.  Root is node 0; -1 terminates."""

    node_min: jax.Array  # f32[M,3]
    node_max: jax.Array  # f32[M,3]
    node_prim: jax.Array  # i32[M]  primitive index if leaf else -1
    node_skip: jax.Array  # i32[M]  next node on AABB miss (-1 = done)
    n_nodes: jax.Array  # i32[]   number of valid nodes

    @property
    def capacity(self) -> int:
        return self.node_prim.shape[0]


def primitive_aabbs(scene: Scene, idx: np.ndarray):
    """AABBs for primitives ``idx`` (host, NumPy)."""
    c = scene.center[idx]
    s = scene.size[idx]
    t = scene.prim_type[idx]
    bmin = np.empty_like(c)
    bmax = np.empty_like(c)
    for row, (pt, cc, ss) in enumerate(zip(t, c, s)):
        if pt == 0:  # sphere
            r = abs(ss[0])
            bmin[row] = cc - r
            bmax[row] = cc + r
            vel = scene.velocity[idx[row]]
            if (vel != 0).any():
                # moving sphere (motion blur): the box covers the whole
                # shutter sweep [c, c + v] so BVH nodes never cull a
                # moved position
                bmin[row] = np.minimum(bmin[row], cc + vel - r)
                bmax[row] = np.maximum(bmax[row], cc + vel + r)
        elif pt == 5:  # medium BOX: half-extents ride the edge1 row
            he = np.abs(scene.edge1[idx[row]])
            yawv = float(scene.edge2[idx[row], 0])
            if yawv:
                # yaw-rotated box: the world AABB of the rotated extents
                # (|c|/|s| sweep — conservative superset for culling)
                cy, sy = abs(np.cos(yawv)), abs(np.sin(yawv))
                he = np.array([cy * he[0] + sy * he[2], he[1],
                               sy * he[0] + cy * he[2]], np.float32)
            bmin[row] = cc - he
            bmax[row] = cc + he
        elif pt == 4:  # triangle: hull of v0, v0+e1, v0+e2 (+ flat-axis pad)
            i = idx[row]
            pts = np.stack([cc, cc + scene.edge1[i], cc + scene.edge2[i]])
            bmin[row] = pts.min(axis=0) - RECT_PAD
            bmax[row] = pts.max(axis=0) + RECT_PAD
        else:
            half = np.zeros(3, np.float32)
            k = _K_AXIS[int(pt)]
            if pt == 1:  # xy: width->x, height->y
                half[0], half[1] = ss[0] / 2, ss[1] / 2
            elif pt == 2:  # xz: width->x, height->z
                half[0], half[2] = ss[0] / 2, ss[1] / 2
            else:  # yz: height->y, width->z (Hittable.cuh:279-293)
                half[1], half[2] = ss[1] / 2, ss[0] / 2
            half[k] = RECT_PAD
            bmin[row] = cc - half
            bmax[row] = cc + half
    return bmin, bmax


def _build_numpy(bmin: np.ndarray, bmax: np.ndarray, prim_ids: np.ndarray):
    """Median-split builder -> DFS-ordered (node_min, node_max, prim, skip)."""
    n = len(prim_ids)
    cent = 0.5 * (bmin + bmax)

    node_min, node_max, node_prim = [], [], []

    def emit(mn, mx, prim):
        node_min.append(mn)
        node_max.append(mx)
        node_prim.append(prim)
        return len(node_prim) - 1

    def build(ids):
        mn = bmin[ids].min(0)
        mx = bmax[ids].max(0)
        if len(ids) == 1:
            emit(mn, mx, int(prim_ids[ids[0]]))
            return
        axis = int(np.argmax(mx - mn))
        order = ids[np.argsort(cent[ids, axis], kind="stable")]
        half = len(order) // 2
        emit(mn, mx, -1)
        build(order[:half])
        build(order[half:])

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 100))
    try:
        build(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(node_prim)
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    node_prim = np.asarray(node_prim, np.int32)

    # skip links: next DFS node after this subtree.  Compute via a stack walk:
    # subtree size = 1 for leaf, else 1 + size(l) + size(r); since DFS order,
    # skip[i] = i + subtree_size(i), with m -> -1 sentinel.
    size = np.ones(m, np.int64)
    # compute subtree sizes bottom-up: iterate reversed, using a stack of sizes
    stack: list[int] = []
    for i in range(m - 1, -1, -1):
        if node_prim[i] >= 0:
            stack.append(1)
        else:
            right = stack.pop()
            left = stack.pop()
            size[i] = 1 + left + right
            stack.append(int(size[i]))
    skip = np.arange(m, dtype=np.int64) + size
    node_skip = np.where(skip >= m, -1, skip).astype(np.int32)
    return node_min, node_max, node_prim, node_skip


def build_bvh(scene: Scene, capacity: int | None = None, use_native: bool = True) -> BVHData:
    """Build the BVH over the scene's ACTIVE primitives.

    The reference filters inactive entries with thrust::remove_if at build
    time (Hittable.cuh:311-312); we do the same on the host, so the device
    traversal never needs the active mask.

    Constant-density MEDIA (mat ISOTROPIC) and MOVING spheres (motion
    blur) are excluded from the tree: the medium boundary is not a
    surface, and a moving sphere's hit depends on the path's shutter
    time — make_bvh_hit_fn tests both with a brute side pass and
    combines closest-hit (their counts are a handful per scene).
    """
    idx = scene.active_indices()
    from .scene import ISOTROPIC as _ISO

    keep = (scene.mat_type[idx] != _ISO) \
        & ~(np.abs(scene.velocity[idx]) > 0).any(axis=1)
    idx = idx[keep]
    if capacity is None:
        capacity = 2 * scene.capacity
    if len(idx) == 0:
        return BVHData(
            node_min=jnp.zeros((capacity, 3), jnp.float32),
            node_max=jnp.zeros((capacity, 3), jnp.float32),
            node_prim=jnp.full((capacity,), -1, jnp.int32),
            node_skip=jnp.full((capacity,), -1, jnp.int32),
            n_nodes=jnp.int32(0),
        )
    bmin, bmax = primitive_aabbs(scene, idx)

    built = None
    if use_native:
        try:
            from ..native import bvh_native

            built = bvh_native.build(bmin, bmax, idx.astype(np.int32))
        except Exception:
            built = None
    if built is None:
        built = _build_numpy(bmin, bmax, idx.astype(np.int64))
    node_min, node_max, node_prim, node_skip = built

    m = len(node_prim)
    if m > capacity:
        raise ValueError(f"BVH nodes {m} exceed capacity {capacity}")
    pad = capacity - m
    node_min = np.pad(node_min, ((0, pad), (0, 0)))
    node_max = np.pad(node_max, ((0, pad), (0, 0)))
    node_prim = np.pad(node_prim, (0, pad), constant_values=-1)
    node_skip = np.pad(node_skip, (0, pad), constant_values=-1)
    return BVHData(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        node_prim=jnp.asarray(node_prim),
        node_skip=jnp.asarray(node_skip),
        n_nodes=jnp.int32(m),
    )


def resolve_traversal(traversal: str | None = None) -> str:
    """The closest-hit traversal to use: ``"kernel"`` (the Pallas/Triton
    kernel, ops/bvh_kernel.py) on a GPU backend, ``"xla"``
    (ops/bvh_traverse.py) elsewhere; an explicit choice wins.
    ``"interpret"`` runs the kernel through the Pallas interpreter."""
    if traversal is None:
        traversal = "kernel" if jax.default_backend() == "gpu" else "xla"
    if traversal not in ("kernel", "xla", "interpret"):
        raise ValueError(f"unknown BVH traversal {traversal!r}")
    return traversal


def make_bvh_hit_fn(bvh: BVHData, scene_data, t_min: float = 0.001,
                    traversal: str | None = None, media: bool = True):
    """Closest-hit function (org, dirn) -> (hit, t, idx) using the BVH.

    Drop-in replacement for the brute-force ops.intersect.hit_scene path
    (the renderer's hit_fn hook).  The tree walk is resolve_traversal's
    choice; ``traversal`` overrides it (tests compare the walks).
    ``media=False`` leaves constant-density media out entirely (the
    G-buffer sees through them, ops/gbuffer.py).
    """
    from ..ops.bvh_kernel import bvh_closest_hit_kernel, pack_tables
    from ..ops.bvh_traverse import bvh_closest_hit

    traversal = resolve_traversal(traversal)
    tri_kw = (dict(edge1=scene_data.edge1, edge2=scene_data.edge2)
              if scene_data.has_triangles else {})
    if traversal == "xla":
        def closest(org, dirn):
            return bvh_closest_hit(org, dirn, bvh, scene_data.prim_type,
                                   scene_data.center, scene_data.size,
                                   t_min=t_min, **tri_kw)
    else:
        # packed here, once per traced frame: the bounce loop reuses them
        tables = pack_tables(bvh, scene_data.prim_type, scene_data.center,
                             scene_data.size, **tri_kw)

        def closest(org, dirn):
            return bvh_closest_hit_kernel(
                org, dirn, tables, t_min=t_min,
                interpret=traversal == "interpret")
    with_media = media and scene_data.has_media

    def hit_fn(org, dirn, u_med=None, time=None):
        hit, t, idx = closest(org, dirn)
        if with_media or scene_data.has_motion:
            # media and moving spheres live OUTSIDE the tree (build_bvh
            # docstring): one brute side scan over just those prims
            # combines by closest hit — order-free, both candidate t's
            # are deterministic given (ray, u_med, time)
            from ..ops import intersect as _it
            from .scene import ISOTROPIC as _ISO

            side = jnp.zeros_like(scene_data.active)
            kw = {}
            if with_media:
                side = side | (scene_data.mat_type == _ISO)
                kw.update(mat_type=scene_data.mat_type,
                          density=scene_data.density, u_med=u_med)
                if scene_data.has_box_media:
                    # box-bounded media: half-extents in the edge1 rows
                    kw.update(half_ext=scene_data.edge1)
                    if scene_data.has_rot_media:
                        # yaw-rotated boxes: yaw rides edge2[:,0]
                        kw.update(yaw=scene_data.edge2[:, 0])
            if scene_data.has_motion:
                side = side | jnp.any(scene_data.velocity != 0, axis=1)
                kw.update(velocity=scene_data.velocity, time=time)
            mhit, mt, midx = _it.hit_scene(
                org, dirn, scene_data.prim_type, scene_data.center,
                scene_data.size, scene_data.active & side, t_min=t_min,
                **kw,
            )
            t_or_big = jnp.where(hit, t, _it.BIG)
            closer = mhit & (mt < t_or_big)
            hit = hit | mhit
            t = jnp.where(closer, mt, t)
            idx = jnp.where(closer, midx, idx)
        return hit, t, idx

    return hit_fn
