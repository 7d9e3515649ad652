"""Scene representation: flat SoA device tensors + host-side CRUD.

Re-architecture of the reference's scene storage and editing:

  * The reference builds a pointer-union object graph inside one
    ``cudaMallocManaged`` slab with placement-new
    (reference: CudaRayTracer/src/Cuda/CudaLayer.cpp:103-362) and edits it in
    place from the UI, reusing freed slots via an inactive free-list
    (CudaLayer.h:110, AddHittable CudaLayer.cpp:918-1370, DeleteHittable
    1372-1387, ClearScene 1565-1572).
  * Here the scene is a set of fixed-capacity padded struct-of-arrays device
    tensors (``SceneData``) plus a host-side mutable mirror (``Scene``).
    Fixed capacity + an ``active`` mask means scene edits NEVER change array
    shapes, so the jitted render function never recompiles; an edit is a
    cheap host mutation + re-upload of kilobyte-sized arrays.
  * Image textures live in a fixed-slot uint8 atlas (analog of the managed
    image allocations in ImageAllocation, CudaLayer.cpp:874-916).
  * Scene save/load (JSON + npz atlas) is an improvement over the reference,
    which cannot persist scenes (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import intersect, materials, textures
from ..ops.sky import DEFAULT_BACKGROUND_END, DEFAULT_BACKGROUND_START

# Re-export type ids at the scene level for convenience.
SPHERE = intersect.SPHERE
XY_RECT = intersect.XY_RECT
XZ_RECT = intersect.XZ_RECT
YZ_RECT = intersect.YZ_RECT
TRIANGLE = intersect.TRIANGLE
BOX = intersect.BOX
LAMBERTIAN = materials.LAMBERTIAN
METAL = materials.METAL
DIELECTRIC = materials.DIELECTRIC
DIFFUSE_LIGHT = materials.DIFFUSE_LIGHT
ISOTROPIC = materials.ISOTROPIC
CONSTANT = textures.CONSTANT
CHECKER = textures.CHECKER
IMAGE = textures.IMAGE
NOISE = textures.NOISE

PRIM_NAMES = {SPHERE: "sphere", XY_RECT: "xy_rect", XZ_RECT: "xz_rect", YZ_RECT: "yz_rect", TRIANGLE: "triangle", BOX: "box"}
MAT_NAMES = {LAMBERTIAN: "lambertian", METAL: "metal", DIELECTRIC: "dielectric", DIFFUSE_LIGHT: "diffuse_light", ISOTROPIC: "isotropic"}
TEX_NAMES = {CONSTANT: "constant", CHECKER: "checker", IMAGE: "image",
             NOISE: "noise"}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Device-side scene: every field is a jax array; the whole thing is a pytree.

    ``has_triangles`` is STATIC metadata (part of the treedef, not a traced
    leaf): renderers branch on it in Python to include the triangle
    intersection code only when the scene actually contains triangles, so
    triangle-free scenes trace the identical graph they always did.
    Flipping it (adding the first triangle / removing the last) recompiles
    once — the same accepted cost as a capacity growth.
    """

    prim_type: jax.Array  # i32[N]
    active: jax.Array  # bool[N]
    center: jax.Array  # f32[N,3]  (triangle: v0)
    size: jax.Array  # f32[N,2]  (sphere: radius in col 0; rect: width,height)
    mat_type: jax.Array  # i32[N]
    fuzz: jax.Array  # f32[N]
    ior: jax.Array  # f32[N]
    light: jax.Array  # f32[N]
    tex_type: jax.Array  # i32[N]
    albedo: jax.Array  # f32[N,3]   constant color / checker odd color
    albedo2: jax.Array  # f32[N,3]  checker even color
    tex_id: jax.Array  # i32[N]    atlas slot or -1
    edge1: jax.Array  # f32[N,3]  triangle v1-v0 (zeros elsewhere)
    edge2: jax.Array  # f32[N,3]  triangle v2-v0 (zeros elsewhere)
    uv0: jax.Array  # f32[N,2]  triangle per-vertex texcoords; defaults
    uv1: jax.Array  # f32[N,2]  (0,0)/(1,0)/(0,1) make the interpolated
    uv2: jax.Array  # f32[N,2]  uv equal the barycentric (u,v)
    vnorm0: jax.Array  # f32[N,3]  triangle per-vertex shading normals;
    vnorm1: jax.Array  # f32[N,3]  all-zero rows mean "flat" (use the
    vnorm2: jax.Array  # f32[N,3]  face normal)
    density: jax.Array  # f32[N]  constant-medium density (ISOTROPIC prims)
    velocity: jax.Array  # f32[N,3] per-shutter sphere motion (motion blur)
    atlas: jax.Array  # uint8[S,AH,AW,3]
    tex_hw: jax.Array  # i32[S,2]
    background_start: jax.Array  # f32[3]
    background_end: jax.Array  # f32[3]
    has_triangles: bool = dataclasses.field(
        default=False, metadata={"static": True})
    has_vertex_attrs: bool = dataclasses.field(
        default=False, metadata={"static": True})
    # constant-density media present (ISOTROPIC material, RTOW book-2
    # ConstantMedium analog) — STATIC like has_triangles: media-free
    # scenes trace the identical graph they always did
    has_media: bool = dataclasses.field(
        default=False, metadata={"static": True})
    # moving spheres present (RTOW book-2 motion blur) — STATIC: static
    # scenes trace the identical graph they always did
    has_motion: bool = dataclasses.field(
        default=False, metadata={"static": True})
    # BOX-bounded media present (prim BOX, half-extents in edge1) —
    # STATIC: sphere-only media scenes skip the slab-chord branch
    has_box_media: bool = dataclasses.field(
        default=False, metadata={"static": True})
    # yaw-ROTATED box media present (RTOW rotate_y; yaw rides edge2[0])
    # — STATIC: axis-aligned box scenes keep their bit-identical graph
    has_rot_media: bool = dataclasses.field(
        default=False, metadata={"static": True})

    @property
    def capacity(self) -> int:
        return self.prim_type.shape[0]


_PRIM_FIELDS = [
    ("prim_type", np.int32, ()),
    ("active", np.bool_, ()),
    ("center", np.float32, (3,)),
    ("size", np.float32, (2,)),
    ("mat_type", np.int32, ()),
    ("fuzz", np.float32, ()),
    ("ior", np.float32, ()),
    ("light", np.float32, ()),
    ("tex_type", np.int32, ()),
    ("albedo", np.float32, (3,)),
    ("albedo2", np.float32, (3,)),
    ("tex_id", np.int32, ()),
    ("edge1", np.float32, (3,)),
    ("edge2", np.float32, (3,)),
    ("uv0", np.float32, (2,)),
    ("uv1", np.float32, (2,)),
    ("uv2", np.float32, (2,)),
    ("vnorm0", np.float32, (3,)),
    ("vnorm1", np.float32, (3,)),
    ("vnorm2", np.float32, (3,)),
    ("density", np.float32, ()),
    ("velocity", np.float32, (3,)),
]

# Default per-vertex texcoords reproduce the raw barycentric (u, v) after
# interpolation: uv(P) = uv0 + u*(uv1-uv0) + v*(uv2-uv0) = (u, v).
_UV_DEFAULT = (np.float32([0, 0]), np.float32([1, 0]), np.float32([0, 1]))


class Scene:
    """Host-side mutable scene with reference-style CRUD semantics.

    Every mutation bumps ``version`` — the progressive accumulator watches it
    to reset accumulation, the way the reference re-renders after every edit.
    """

    def __init__(
        self,
        capacity: int = 512,
        atlas_slots: int = 4,
        atlas_size: int = 512,
        background_start=DEFAULT_BACKGROUND_START,
        background_end=DEFAULT_BACKGROUND_END,
    ):
        self.capacity = int(capacity)
        for name, dt, extra in _PRIM_FIELDS:
            setattr(self, name, np.zeros((self.capacity,) + extra, dtype=dt))
        # Avoid divide-by-zero on inactive slots.
        self.size[:] = 1.0
        self.ior[:] = 1.0
        self.tex_id[:] = -1
        self.uv0[:], self.uv1[:], self.uv2[:] = _UV_DEFAULT
        self.atlas = np.zeros((atlas_slots, atlas_size, atlas_size, 3), np.uint8)
        self.tex_hw = np.zeros((atlas_slots, 2), np.int32)
        self._atlas_used = [False] * atlas_slots
        self.background_start = np.asarray(background_start, np.float32)
        self.background_end = np.asarray(background_end, np.float32)
        # free-list mirrors the reference's m_InactiveHittables (CudaLayer.h:110)
        self._free = list(range(self.capacity - 1, -1, -1))
        # host-only mesh grouping: triangles added through add_mesh share a
        # group id (-1 = standalone primitive); the viewer edits a mesh as
        # ONE object the way the reference edits one hittable.  Never sent
        # to the device — shading is per-triangle either way.
        self.mesh_id = np.full(self.capacity, -1, np.int32)
        self._next_mesh_id = 0
        self.version = 0

    # ------------------------------------------------------------- counts
    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def active_indices(self) -> np.ndarray:
        return np.nonzero(self.active)[0]

    # ------------------------------------------------------------- CRUD
    def _alloc_slot(self) -> int:
        if not self._free:
            self._grow()
        return self._free.pop()

    def _grow(self):
        """Double capacity (analog of the reference's slab growth,
        CudaLayer.cpp:1123-1150).  Changes array shapes, so the next render
        recompiles — growth is rare and explicit."""
        old = self.capacity
        new = old * 2
        for name, dt, extra in _PRIM_FIELDS:
            arr = getattr(self, name)
            grown = np.zeros((new,) + arr.shape[1:], dtype=arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        self.size[old:] = 1.0
        self.ior[old:] = 1.0
        self.tex_id[old:] = -1
        self.uv0[old:], self.uv1[old:], self.uv2[old:] = _UV_DEFAULT
        grown_mid = np.full(new, -1, np.int32)
        grown_mid[:old] = self.mesh_id
        self.mesh_id = grown_mid
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        self.capacity = new
        self.version += 1

    def _add(
        self,
        ptype: int,
        center,
        size,
        mat_type: int = LAMBERTIAN,
        albedo=(1.0, 1.0, 1.0),
        albedo2=(1.0, 1.0, 1.0),
        tex_type: int = CONSTANT,
        fuzz: float = 0.0,
        ior: float = 1.5,
        light: float = 2.0,
        tex_id: int = -1,
        density: float = 1.0,
    ) -> int:
        i = self._alloc_slot()
        self.prim_type[i] = ptype
        self.center[i] = np.asarray(center, np.float32)
        self.size[i] = np.asarray(size, np.float32)
        self.mat_type[i] = mat_type
        self.fuzz[i] = min(float(fuzz), 1.0)  # reference clamps fuzz to <=1 (Material.cuh:71)
        self.ior[i] = ior
        self.light[i] = light
        self.tex_type[i] = tex_type
        self.albedo[i] = np.asarray(albedo, np.float32)
        self.albedo2[i] = np.asarray(albedo2, np.float32)
        self.tex_id[i] = tex_id
        self.density[i] = density
        self.velocity[i] = 0.0  # recycled slots must not leak motion
        # reset per-vertex attrs and mesh membership: a recycled slot must
        # not leak a previous triangle's uv/normal/group data
        self.uv0[i], self.uv1[i], self.uv2[i] = _UV_DEFAULT
        self.vnorm0[i] = self.vnorm1[i] = self.vnorm2[i] = 0.0
        self.mesh_id[i] = -1
        self.active[i] = True
        self.version += 1
        return i

    def add_sphere(self, center, radius: float, **mat) -> int:
        return self._add(SPHERE, center, (radius, radius), **mat)

    def add_moving_sphere(self, center0, center1, radius: float,
                          **mat) -> int:
        """Sphere that moves from ``center0`` (shutter open, time 0) to
        ``center1`` (shutter close, time 1) — RTOW book-2 motion blur
        (BEYOND-REFERENCE; the reference's world is static).  Each path
        samples one shutter time and the whole path sees the world frozen
        at that instant: center(t) = center0 + t * (center1 - center0)."""
        i = self._add(SPHERE, center0, (radius, radius), **mat)
        self.velocity[i] = (np.asarray(center1, np.float32)
                            - np.asarray(center0, np.float32))
        self.version += 1
        return i

    def add_medium_sphere(self, center, radius: float, density: float = 1.0,
                          **mat) -> int:
        """Constant-density participating medium bounded by a sphere
        (smoke/fog) — the RTOW book-2 ConstantMedium analog
        (BEYOND-REFERENCE; the CUDA reference has no volumes).  The
        boundary is invisible: rays entering the sphere scatter
        isotropically at a distance sampled from exp(-density * s);
        the medium's color is the usual texture stack (albedo or any
        tex_type)."""
        mat.setdefault("mat_type", ISOTROPIC)
        return self._add(SPHERE, center, (radius, radius),
                         density=density, **mat)

    def add_medium_box(self, center, extents, density: float = 1.0,
                       yaw: float = 0.0, **mat) -> int:
        """Constant-density participating medium bounded by a BOX
        (the RTOW book-2 Cornell-smoke shape, BEYOND-REFERENCE; the CUDA
        reference has neither boxes nor volumes).  ``extents`` is the
        box's FULL (x, y, z) size; the half-extents ride the edge1 rows
        (spare for non-triangles).  ``yaw`` rotates the box about the
        world Y axis through its center (radians, same convention as
        transform_mesh — the RTOW rotate_y instance transform); it rides
        edge2[0] (spare for non-triangles), so zero-yaw scenes keep the
        bit-identical axis-aligned graph (static has_rot_media gate).
        The boundary is invisible — rays inside scatter isotropically
        at a distance sampled from exp(-density * s)."""
        mat["mat_type"] = ISOTROPIC  # a BOX is ALWAYS a medium boundary
        he = 0.5 * np.asarray(extents, np.float32)
        i = self._add(BOX, center, (float(he[0]), float(he[1])),
                      density=density, **mat)
        self.edge1[i] = he
        self.edge2[i, 0] = float(yaw)
        self.version += 1
        return i

    def add_xy_rect(self, center, width: float, height: float, **mat) -> int:
        return self._add(XY_RECT, center, (width, height), **mat)

    def add_xz_rect(self, center, width: float, height: float, **mat) -> int:
        return self._add(XZ_RECT, center, (width, height), **mat)

    def add_yz_rect(self, center, width: float, height: float, **mat) -> int:
        return self._add(YZ_RECT, center, (width, height), **mat)

    def add_triangle(self, v0, v1, v2, uv=None, normals=None, **mat) -> int:
        """Add one triangle (BEYOND-REFERENCE: the reference has only
        spheres and axis-aligned rects).  Stored as v0 + two edge vectors;
        the outward normal is normalize((v1-v0) x (v2-v0)) (CCW winding),
        and shading treats it as two-sided like the rects.

        ``uv``: optional per-vertex texcoords, 3 pairs — the hit (u, v)
        becomes the barycentric interpolation of these (default: raw
        barycentrics).  ``normals``: optional per-vertex shading normals,
        3 vectors — shading uses the normalized barycentric interpolation
        (smooth/Phong shading) instead of the face normal."""
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        i = self._add(TRIANGLE, v0, (1.0, 1.0), **mat)
        self.edge1[i] = v1 - v0
        self.edge2[i] = v2 - v0
        if uv is not None:
            uv = np.asarray(uv, np.float32)
            if uv.shape != (3, 2):
                raise ValueError(f"uv must be 3 (u,v) pairs, got {uv.shape}")
            self.uv0[i], self.uv1[i], self.uv2[i] = uv
        if normals is not None:
            normals = np.asarray(normals, np.float32)
            if normals.shape != (3, 3):
                raise ValueError(
                    f"normals must be 3 vectors, got {normals.shape}")
            lens = np.linalg.norm(normals, axis=1, keepdims=True)
            if (lens < 1e-12).any():
                raise ValueError("zero-length vertex normal")
            normals = normals / lens
            self.vnorm0[i], self.vnorm1[i], self.vnorm2[i] = normals
        return i

    def add_mesh(self, vertices, faces, uvs=None, uv_faces=None,
                 normals=None, normal_faces=None, smooth=False,
                 **mat) -> list[int]:
        """Add a triangle mesh: ``vertices`` f32[V,3], ``faces`` i32[F,3]
        (CCW winding).  One material for the whole mesh; returns the new
        slot ids (a Python list, the mesh analog of the reference's
        per-object UI handles).

        Per-vertex attributes (all optional):
          * ``uvs`` f32[VT,2] + ``uv_faces`` i32[F,3] (defaults to
            ``faces``): texcoords, indexed OBJ-style.
          * ``normals`` f32[VN,3] + ``normal_faces`` i32[F,3] (defaults to
            ``faces``): shading normals for smooth shading.
          * ``smooth=True``: no authored normals — compute area-weighted
            vertex normals from the face geometry (utils.mesh.vertex_normals).
        """
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64)
        if smooth and normals is None:
            from ..utils.mesh import vertex_normals

            normals = vertex_normals(vertices, faces)
        tri_uv = None
        if uvs is not None:
            uvs = np.asarray(uvs, np.float32)
            uvf = faces if uv_faces is None else np.asarray(uv_faces, np.int64)
            tri_uv = uvs[uvf]  # [F,3,2]
        tri_n = None
        if normals is not None:
            normals = np.asarray(normals, np.float32)
            nf = (faces if normal_faces is None
                  else np.asarray(normal_faces, np.int64))
            tri_n = normals[nf]  # [F,3,3]
        out = self._bulk_add_triangles(
            vertices[faces[:, 0]], vertices[faces[:, 1]],
            vertices[faces[:, 2]], uv=tri_uv, normals=tri_n, **mat)
        mid = self._next_mesh_id
        self._next_mesh_id += 1
        self.mesh_id[out] = mid
        return out

    def _bulk_add_triangles(self, v0, v1, v2, uv=None, normals=None,
                            mat_type: int = LAMBERTIAN,
                            albedo=(1.0, 1.0, 1.0), albedo2=(1.0, 1.0, 1.0),
                            tex_type: int = CONSTANT, fuzz: float = 0.0,
                            ior: float = 1.5, light: float = 2.0,
                            tex_id: int = -1) -> list[int]:
        """Vectorized add_triangle over F rows: one numpy write per SoA
        column instead of a Python loop per face (measured: a 20k-triangle
        heightfield constructed in ~9 s via the loop, milliseconds here).
        Semantics match F sequential add_triangle calls exactly — same
        slot-allocation order (so table packing stays bit-identical), same
        validation, same material defaults (fuzz clamp, Material.cuh:71).
        ``uv`` is f32[F,3,2], ``normals`` f32[F,3,3] (or None)."""
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        n = len(v0)
        while len(self._free) < n:
            self._grow()
        idx = np.array([self._free.pop() for _ in range(n)], np.int64)
        self.prim_type[idx] = TRIANGLE
        self.center[idx] = v0
        self.size[idx] = (1.0, 1.0)
        self.mat_type[idx] = mat_type
        self.fuzz[idx] = min(float(fuzz), 1.0)
        self.ior[idx] = ior
        self.light[idx] = light
        self.tex_type[idx] = tex_type
        self.albedo[idx] = np.asarray(albedo, np.float32)
        self.albedo2[idx] = np.asarray(albedo2, np.float32)
        self.tex_id[idx] = tex_id
        self.edge1[idx] = v1 - v0
        self.edge2[idx] = v2 - v0
        if uv is not None:
            uv = np.asarray(uv, np.float32)
            if uv.shape != (n, 3, 2):
                raise ValueError(f"uv must be [F,3,2], got {uv.shape}")
            self.uv0[idx], self.uv1[idx], self.uv2[idx] = (
                uv[:, 0], uv[:, 1], uv[:, 2])
        else:
            self.uv0[idx], self.uv1[idx], self.uv2[idx] = _UV_DEFAULT
        if normals is not None:
            normals = np.asarray(normals, np.float32)
            if normals.shape != (n, 3, 3):
                raise ValueError(
                    f"normals must be [F,3,3], got {normals.shape}")
            lens = np.linalg.norm(normals, axis=2, keepdims=True)
            if (lens < 1e-12).any():
                raise ValueError("zero-length vertex normal")
            normals = normals / lens
            self.vnorm0[idx], self.vnorm1[idx], self.vnorm2[idx] = (
                normals[:, 0], normals[:, 1], normals[:, 2])
        else:
            self.vnorm0[idx] = 0.0
            self.vnorm1[idx] = 0.0
            self.vnorm2[idx] = 0.0
        self.mesh_id[idx] = -1
        self.active[idx] = True
        self.version += 1
        return [int(i) for i in idx]

    # ------------------------------------------------------------- meshes
    def mesh_group_ids(self) -> list[int]:
        """Group ids of all active meshes, ascending."""
        mids = np.unique(self.mesh_id[self.active])
        return [int(m) for m in mids if m >= 0]

    def mesh_indices(self, mid: int) -> np.ndarray:
        """Active slot indices of mesh group ``mid``."""
        return np.nonzero(self.active & (self.mesh_id == mid))[0]

    def update_mesh(self, mid: int, **fields):
        """Edit a per-primitive field on EVERY triangle of a mesh — the
        one-hittable-one-material semantics of add_mesh, kept editable."""
        idx = self.mesh_indices(mid)
        if idx.size == 0:
            raise ValueError(f"mesh {mid} has no active triangles")
        for i in idx:
            self.update(int(i), **fields)

    def transform_mesh(self, mid: int, scale: float = 1.0,
                       rotate_y: float = 0.0):
        """Uniform-scale and/or yaw-rotate (radians) a mesh group about
        its centroid: vertex positions, edge vectors AND shading normals
        transform together (normals only rotate — uniform scale preserves
        them; uvs are intrinsic and unchanged).  Same rotation convention
        as utils.mesh.transformed.  Host-side SoA writes; like every edit,
        the next frame repacks tables without recompiling."""
        if not scale > 0.0:
            # scale 0 collapses edges to NaN-normal degenerates; negative
            # scale mirrors the winding while vertex normals keep pointing
            # the old way — both rejected
            raise ValueError(f"transform_mesh scale must be > 0, got {scale}")
        idx = self.mesh_indices(mid)
        if idx.size == 0:
            raise ValueError(f"mesh {mid} has no active triangles")
        from ..utils.mesh import rot_y

        R = rot_y(rotate_y)
        # centroid over all vertices (v0, v1 = v0+e1, v2 = v0+e2)
        v0 = self.center[idx]
        v1 = v0 + self.edge1[idx]
        v2 = v0 + self.edge2[idx]
        ctr = np.concatenate([v0, v1, v2]).mean(0)
        sf = np.float32(scale)
        self.center[idx] = (v0 - ctr) * sf @ R.T + ctr
        self.edge1[idx] = self.edge1[idx] * sf @ R.T
        self.edge2[idx] = self.edge2[idx] * sf @ R.T
        if rotate_y:
            for vn in (self.vnorm0, self.vnorm1, self.vnorm2):
                live = vn[idx]
                flat = (live == 0.0).all(1)  # keep the flat sentinel
                vn[idx] = np.where(flat[:, None], live, live @ R.T)
        self.version += 1

    def delete_mesh(self, mid: int):
        """Deactivate every triangle of a mesh group."""
        idx = self.mesh_indices(mid)
        if idx.size == 0:
            raise ValueError(f"mesh {mid} has no active triangles")
        for i in idx:
            self.delete(int(i))

    @property
    def num_triangles(self) -> int:
        return int((self.active & (self.prim_type == TRIANGLE)).sum())

    @property
    def has_vertex_attrs(self) -> bool:
        """True when any active triangle carries non-default per-vertex
        uvs or any vertex normals — the static gate for the interpolation
        code (SceneData.has_vertex_attrs)."""
        tri = self.active & (self.prim_type == TRIANGLE)
        if not tri.any():
            return False
        if (self.vnorm0[tri] != 0).any() or (self.vnorm1[tri] != 0).any() \
                or (self.vnorm2[tri] != 0).any():
            return True
        u0, u1, u2 = _UV_DEFAULT
        return bool((self.uv0[tri] != u0).any() or (self.uv1[tri] != u1).any()
                    or (self.uv2[tri] != u2).any())

    def delete(self, i: int):
        """Deactivate a slot and recycle it (DeleteHittable, CudaLayer.cpp:1372-1387)."""
        if not self.active[i]:
            raise ValueError(f"slot {i} is not active")
        self.active[i] = False
        self._free.append(int(i))
        self.version += 1

    def clear(self, keep: Optional[list[int]] = None):
        """Deactivate all primitives except ``keep`` (ClearScene keeps the
        ground, CudaLayer.cpp:1565-1572)."""
        keep = set(keep or [])
        for i in self.active_indices():
            if int(i) not in keep:
                self.active[i] = False
                self._free.append(int(i))
        self.version += 1

    def update(self, i: int, **fields):
        """Edit any per-primitive field in place (the UI drag paths,
        CudaLayer.cpp:484-563, 719-872)."""
        if (int(self.prim_type[i]) == BOX and "mat_type" in fields
                and int(fields["mat_type"]) != ISOTROPIC):
            # a BOX is exclusively a constant-medium boundary: a surface
            # material would pack a junk ptype-5 column (invisible in the
            # XLA paths, spuriously rect-hittable in a mixed cluster)
            raise ValueError("BOX primitives are always ISOTROPIC media")
        if "yaw" in fields:
            # yaw is a BOX-medium pseudo-field riding edge2[0] (the
            # rotate_y transform; add_medium_box docstring)
            if int(self.prim_type[i]) != BOX:
                raise ValueError("yaw applies to BOX media only")
            self.edge2[i, 0] = float(fields.pop("yaw"))
        for k, val in fields.items():
            arr = getattr(self, k, None)
            if arr is None or not isinstance(arr, np.ndarray) or arr.shape[0] != self.capacity:
                raise KeyError(f"unknown primitive field {k!r}")
            arr[i] = val
        self.version += 1

    # ------------------------------------------------------------- textures
    def load_image_texture(self, image) -> int:
        """Upload an RGB image (HxWx3 uint8 array, PIL image, or path) into a
        free atlas slot; returns the slot id for use as ``tex_id``.

        Analog of ImageAllocation (CudaLayer.cpp:874-916) + stb loading
        (Utils/RawStbImage.h:12-22).
        """
        arr = _as_rgb_u8(image)
        slots, ah, aw, _ = self.atlas.shape
        h, w = arr.shape[:2]
        if h > ah or w > aw:
            # Downscale with Pillow to fit the fixed atlas tile.
            from ..utils.image import require_pillow

            im = require_pillow("downscaling a texture")
            im = im.fromarray(arr)
            scale = min(ah / h, aw / w)
            im = im.resize((max(1, int(w * scale)), max(1, int(h * scale))))
            arr = np.asarray(im, np.uint8)
            h, w = arr.shape[:2]
        for s in range(slots):
            if not self._atlas_used[s]:
                self.atlas[s, :h, :w] = arr
                self.tex_hw[s] = (h, w)
                self._atlas_used[s] = True
                self.version += 1
                return s
        raise RuntimeError("texture atlas is full")

    def free_image_texture(self, slot: int):
        """Release an atlas slot (DeleteImageAllocation, CudaLayer.cpp:1389-1563)."""
        self._atlas_used[slot] = False
        self.tex_hw[slot] = (0, 0)
        self.version += 1

    # ------------------------------------------------------------- device
    def device(self, device=None) -> SceneData:
        """Snapshot the host mirror into a device pytree.

        ``device``: explicit jax device to place the arrays on (default:
        JAX's default device)."""
        def put(x):
            return (jnp.asarray(x) if device is None
                    else jax.device_put(np.asarray(x), device))

        kw = {name: put(getattr(self, name)) for name, _, _ in _PRIM_FIELDS}
        return SceneData(
            atlas=put(self.atlas),
            tex_hw=put(self.tex_hw),
            background_start=put(self.background_start),
            background_end=put(self.background_end),
            has_triangles=self.num_triangles > 0,
            has_vertex_attrs=self.has_vertex_attrs,
            has_media=bool(
                (self.mat_type[self.active] == ISOTROPIC).any()),
            has_motion=bool(
                (np.abs(self.velocity[self.active]) > 0).any()),
            has_box_media=bool(
                (self.prim_type[self.active] == BOX).any()),
            has_rot_media=bool(
                (self.edge2[self.active &
                            (self.prim_type == BOX), 0] != 0).any()),
            **kw,
        )

    # ------------------------------------------------------------- persistence
    def to_doc(self, embed_atlas: bool = False) -> dict:
        """The scene as a JSON-able document (docs/SCENE_FORMAT.md).
        ``embed_atlas=True`` inlines the used image-texture atlas as a
        base64 compressed npz (``atlas_b64``) so ONE document is fully
        portable — the viewer's download/import buttons use this; the
        file-based save/load keeps the sidecar .npz instead."""
        doc = {
            "capacity": self.capacity,
            "background_start": self.background_start.tolist(),
            "background_end": self.background_end.tolist(),
            "primitives": [],
        }
        for i in self.active_indices():
            p = {
                "prim_type": int(self.prim_type[i]),
                "center": self.center[i].tolist(),
                "size": self.size[i].tolist(),
                "mat_type": int(self.mat_type[i]),
                "fuzz": float(self.fuzz[i]),
                "ior": float(self.ior[i]),
                "light": float(self.light[i]),
                "tex_type": int(self.tex_type[i]),
                "albedo": self.albedo[i].tolist(),
                "albedo2": self.albedo2[i].tolist(),
                "tex_id": int(self.tex_id[i]),
            }
            if self.mat_type[i] == ISOTROPIC:
                p["density"] = float(self.density[i])
            if (self.velocity[i] != 0).any():
                p["velocity"] = self.velocity[i].tolist()
            if self.prim_type[i] == BOX:
                p["half_ext"] = self.edge1[i].tolist()
                if self.edge2[i, 0] != 0.0:
                    p["yaw"] = float(self.edge2[i, 0])
            if self.prim_type[i] == TRIANGLE:
                p["edge1"] = self.edge1[i].tolist()
                p["edge2"] = self.edge2[i].tolist()
                uv = np.stack([self.uv0[i], self.uv1[i], self.uv2[i]])
                if (uv != np.stack(_UV_DEFAULT)).any():
                    p["uv"] = uv.tolist()
                vn = np.stack(
                    [self.vnorm0[i], self.vnorm1[i], self.vnorm2[i]])
                if (vn != 0).any():
                    p["vnormals"] = vn.tolist()
                if self.mesh_id[i] >= 0:
                    p["mesh_id"] = int(self.mesh_id[i])
            doc["primitives"].append(p)
        if embed_atlas and any(self._atlas_used):
            import base64
            import io as _io

            buf = _io.BytesIO()
            np.savez_compressed(buf, atlas=self.atlas, tex_hw=self.tex_hw)
            doc["atlas_b64"] = base64.b64encode(buf.getvalue()).decode()
        return doc

    def save(self, path: str):
        """Serialize to JSON (+ sidecar .npz for the atlas when used)."""
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, indent=1)
        if any(self._atlas_used):
            np.savez_compressed(path + ".atlas.npz", atlas=self.atlas, tex_hw=self.tex_hw)

    def _restore_atlas(self, npz_file):
        """Adopt a saved atlas npz (file path or file-like): atlas texels,
        per-slot dims, and the used-slot mask derived from them."""
        side = np.load(npz_file)
        self.atlas = side["atlas"]
        self.tex_hw = side["tex_hw"]
        self._atlas_used = [bool(h) for h, _ in self.tex_hw]

    @classmethod
    def from_doc(cls, doc: dict, **kwargs) -> "Scene":
        """Build a scene from a to_doc()/SCENE_FORMAT document (restores
        an embedded ``atlas_b64`` when present)."""
        scene = cls._from_doc_body(doc, **kwargs)
        if "atlas_b64" in doc:
            import base64
            import io as _io

            scene._restore_atlas(
                _io.BytesIO(base64.b64decode(doc["atlas_b64"])))
        return scene

    @classmethod
    def load(cls, path: str, **kwargs) -> "Scene":
        with open(path) as f:
            doc = json.load(f)
        scene = cls._from_doc_body(doc, **kwargs)
        try:
            scene._restore_atlas(path + ".atlas.npz")
        except FileNotFoundError:
            pass
        return scene

    @classmethod
    def _from_doc_body(cls, doc: dict, **kwargs) -> "Scene":
        scene = cls(
            capacity=doc.get("capacity", 512),
            background_start=doc["background_start"],
            background_end=doc["background_end"],
            **kwargs,
        )
        for p in doc["primitives"]:
            i = scene._add(
                p["prim_type"],
                p["center"],
                p["size"],
                mat_type=p["mat_type"],
                fuzz=p["fuzz"],
                ior=p["ior"],
                light=p["light"],
                tex_type=p["tex_type"],
                albedo=p["albedo"],
                albedo2=p["albedo2"],
                tex_id=p["tex_id"],
                density=p.get("density", 1.0),
            )
            if "velocity" in p:
                scene.velocity[i] = np.asarray(p["velocity"], np.float32)
            if p["prim_type"] == BOX:
                scene.edge1[i] = np.asarray(p["half_ext"], np.float32)
                scene.edge2[i, 0] = float(p.get("yaw", 0.0))
                # a BOX is always a medium boundary (hand-edited docs):
                # a surface material would pack a junk ptype-5 column
                scene.mat_type[i] = ISOTROPIC
            if p["prim_type"] == TRIANGLE:
                scene.edge1[i] = np.asarray(p["edge1"], np.float32)
                scene.edge2[i] = np.asarray(p["edge2"], np.float32)
                if "uv" in p:
                    uv = np.asarray(p["uv"], np.float32)
                    scene.uv0[i], scene.uv1[i], scene.uv2[i] = uv
                if "vnormals" in p:
                    vn = np.asarray(p["vnormals"], np.float32)
                    scene.vnorm0[i], scene.vnorm1[i], scene.vnorm2[i] = vn
                if "mesh_id" in p:
                    scene.mesh_id[i] = int(p["mesh_id"])
                    scene._next_mesh_id = max(scene._next_mesh_id,
                                              int(p["mesh_id"]) + 1)
        return scene


def _as_rgb_u8(image) -> np.ndarray:
    if isinstance(image, str):
        from ..utils.image import require_pillow

        image = require_pillow("loading an image file").open(image).convert(
            "RGB")
    if hasattr(image, "mode"):  # PIL image
        image = np.asarray(image.convert("RGB"), np.uint8)
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected HxWx3 RGB image, got {arr.shape}")
    return arr
