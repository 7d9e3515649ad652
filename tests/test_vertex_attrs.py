"""Per-vertex UV / smooth-normal tests (BEYOND-REFERENCE).

The reference has no triangles at all (its primitives are spheres and
axis-aligned rects, CudaRayTracer/src/Hittables/Hittable.cuh:30-38); this
framework adds meshes with OPTIONAL per-vertex texcoords and shading
normals, statically gated by SceneData.has_vertex_attrs so plain scenes
trace the identical graphs.  Coverage: the static gate, default-attr
bit-compatibility, interpolation correctness (textured quad == image
rect; smooth icosphere ~= analytic sphere), attribute-aware OBJ I/O,
persistence, and end-to-end renders on brute + BVH.
"""

import numpy as np
import pytest

from cudaraytracer_tpu.models import bvh as bvhm
from cudaraytracer_tpu.models.camera import make_camera_params
from cudaraytracer_tpu.models.renderer import Renderer
from cudaraytracer_tpu.models.scene import IMAGE, Scene
from cudaraytracer_tpu.ops import intersect as isect
from cudaraytracer_tpu.utils import mesh
from cudaraytracer_tpu.utils import rng as rngu

RNG = np.random.RandomState(11)


def _checker_image(n=64, k=8):
    """RGB test chart with distinct quadrant colors (orientation-sensitive)."""
    img = np.zeros((n, n, 3), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    img[..., 0] = np.where(((xx // k) + (yy // k)) % 2 == 0, 230, 30)
    img[..., 1] = (255 * xx // n).astype(np.uint8)
    img[..., 2] = (255 * yy // n).astype(np.uint8)
    return img


# ----------------------------------------------------------- static gate
def test_has_vertex_attrs_gate():
    sc = Scene(capacity=16)
    sc.add_sphere((0, 0, 0), 1.0)
    assert not sc.has_vertex_attrs
    i = sc.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    assert not sc.has_vertex_attrs  # default attrs are not "attrs"
    assert not sc.device().has_vertex_attrs
    sc.delete(i)
    j = sc.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                        uv=[(0, 0), (2, 0), (0, 2)])
    assert sc.has_vertex_attrs
    assert sc.device().has_vertex_attrs
    sc.delete(j)
    assert not sc.has_vertex_attrs
    # a recycled slot must not leak old attrs into a plain triangle
    sc.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0))
    assert not sc.has_vertex_attrs
    sc.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0),
                    normals=[(0, 0, 1)] * 3)
    assert sc.has_vertex_attrs


def test_default_attrs_are_bit_identical():
    """Passing the default uv rows + zero vnorms through the interpolation
    path must reproduce the plain record EXACTLY (bit-level)."""
    sc = Scene(capacity=16)
    sc.add_triangle((-2, -2, -3), (2, -2, -3), (0, 2, -3))
    r = 64
    org = np.zeros((r, 3), np.float32)
    dirn = RNG.uniform(-1, 1, (r, 3)).astype(np.float32)
    dirn[:, 2] = -1.0
    hit, t, idx = isect.hit_scene(
        org, dirn, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2)
    plain = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2)
    attrs = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2,
        uv0=sc.uv0, uv1=sc.uv1, uv2=sc.uv2,
        vnorm0=sc.vnorm0, vnorm1=sc.vnorm1, vnorm2=sc.vnorm2)
    h = np.asarray(hit)
    assert h.sum() >= 10
    for a, b in zip(plain, attrs):
        a, b = np.asarray(a), np.asarray(b)
        # records are only defined on hit lanes (miss lanes hold garbage
        # barycentrics in both variants)
        np.testing.assert_array_equal(a[h], b[h])


# ------------------------------------------------------- uv interpolation


@pytest.mark.slow
def test_textured_quad_matches_image_rect():
    """Two UV-mapped triangles forming a rect must render the image texture
    pixel-for-pixel like the rect primitive itself."""
    img = _checker_image()
    cam = make_camera_params(origin=(0, 0, 2.2), forward=(0, 0, -1))
    key = rngu.base_key(5)

    def render(sc):
        r = Renderer(48, 48, camera_model="look_at", accel="brute")
        return np.asarray(
            r.render(sc.device(), cam, key, spp=2, max_depth=3)) / 2.0

    # reference: xy_rect centered at origin, 2x2, image texture
    sc_rect = Scene(capacity=8)
    slot = sc_rect.load_image_texture(img)
    sc_rect.add_xy_rect((0, 0, 0), 2.0, 2.0, tex_type=IMAGE, tex_id=slot)

    # same geometry as two triangles; rect u = (x+1)/2, v = (y+1)/2
    sc_tri = Scene(capacity=8)
    slot2 = sc_tri.load_image_texture(img)
    v = np.array([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)], np.float32)
    uv = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    f = np.array([(0, 1, 2), (0, 2, 3)], np.int64)
    sc_tri.add_mesh(v, f, uvs=uv, tex_type=IMAGE, tex_id=slot2)
    assert sc_tri.has_vertex_attrs

    img_rect = render(sc_rect)
    img_tri = render(sc_tri)
    # same camera jitter stream, same hit geometry, same texel lookups ->
    # agreement to fp noise (the diagonal seam is exact: both triangles
    # interpolate the same bilinear uv map)
    np.testing.assert_allclose(img_tri, img_rect, atol=2e-3)


def test_uv_interpolation_formula():
    """Interpolated (u,v) matches uv0 + u*(uv1-uv0) + v*(uv2-uv0)."""
    sc = Scene(capacity=8)
    uv = np.array([(0.2, 0.3), (0.9, 0.1), (0.4, 0.8)], np.float32)
    sc.add_triangle((-1, -1, -2), (1, -1, -2), (0, 1, -2), uv=uv)
    r = 128
    org = np.zeros((r, 3), np.float32)
    dirn = np.stack([
        RNG.uniform(-0.4, 0.4, r), RNG.uniform(-0.4, 0.4, r),
        np.full(r, -1.0)], axis=1).astype(np.float32)
    hit, t, idx = isect.hit_scene(
        org, dirn, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2)
    bare = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2)
    rec = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2,
        uv0=sc.uv0, uv1=sc.uv1, uv2=sc.uv2,
        vnorm0=sc.vnorm0, vnorm1=sc.vnorm1, vnorm2=sc.vnorm2)
    h = np.asarray(hit)
    assert h.sum() > 20
    bu, bv = np.asarray(bare.u)[h], np.asarray(bare.v)[h]
    want_u = uv[0, 0] + bu * (uv[1, 0] - uv[0, 0]) + bv * (uv[2, 0] - uv[0, 0])
    want_v = uv[0, 1] + bu * (uv[1, 1] - uv[0, 1]) + bv * (uv[2, 1] - uv[0, 1])
    np.testing.assert_allclose(np.asarray(rec.u)[h], want_u, atol=1e-5)
    np.testing.assert_allclose(np.asarray(rec.v)[h], want_v, atol=1e-5)


# --------------------------------------------------------- smooth normals
def test_smooth_icosphere_normals_near_analytic():
    """Icosphere with exact vertex normals: interpolated shading normals
    track the analytic sphere normal far better than face normals do."""
    v, f = mesh.icosphere(2)  # 320 faces
    sc = Scene(capacity=512)
    sc.add_mesh(v, f, normals=v)  # unit sphere: normal == position
    assert sc.has_vertex_attrs

    r = 256
    # rays from outside toward sphere center, random directions
    org = np.full((r, 3), (0.0, 0.0, 3.0), np.float32)
    dirn = np.stack([
        RNG.uniform(-0.3, 0.3, r), RNG.uniform(-0.3, 0.3, r),
        np.full(r, -1.0)], axis=1).astype(np.float32)
    hit, t, idx = isect.hit_scene(
        org, dirn, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2)
    flat = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2)
    smooth = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2,
        uv0=sc.uv0, uv1=sc.uv1, uv2=sc.uv2,
        vnorm0=sc.vnorm0, vnorm1=sc.vnorm1, vnorm2=sc.vnorm2)
    h = np.asarray(hit)
    assert h.sum() > 100
    p = np.asarray(smooth.point)[h]
    exact = p / np.linalg.norm(p, axis=1, keepdims=True)

    def max_angle(n):
        cos = np.clip(np.sum(np.asarray(n)[h] * exact, axis=1), -1, 1)
        return np.degrees(np.arccos(cos)).max()

    a_smooth = max_angle(smooth.normal)
    a_flat = max_angle(flat.normal)
    assert a_smooth < 2.5, a_smooth  # interpolated: degree-level agreement
    assert a_flat > 4.0, a_flat      # face normals: visibly faceted
    # unit length
    lens = np.linalg.norm(np.asarray(smooth.normal)[h], axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)


def test_smooth_normal_two_sided_flip():
    """Hit from behind: the shading normal flips with the geometric side
    and front_face stays geometric."""
    sc = Scene(capacity=8)
    n = (0.0, 0.0, 1.0)
    sc.add_triangle((-1, -1, 0), (1, -1, 0), (0, 1, 0), normals=[n, n, n])
    org = np.array([[0.0, -0.3, -2.0]], np.float32)  # behind the plane
    dirn = np.array([[0.0, 0.0, 1.0]], np.float32)
    hit, t, idx = isect.hit_scene(
        org, dirn, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2)
    rec = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2,
        uv0=sc.uv0, uv1=sc.uv1, uv2=sc.uv2,
        vnorm0=sc.vnorm0, vnorm1=sc.vnorm1, vnorm2=sc.vnorm2)
    assert bool(np.asarray(hit)[0])
    assert not bool(np.asarray(rec.front_face)[0])
    np.testing.assert_allclose(
        np.asarray(rec.normal)[0], (0, 0, -1), atol=1e-6)


def test_mixed_smooth_and_flat_triangles():
    """Zero vnorm rows fall back to the face normal even when the scene's
    attr gate is on (one smooth triangle elsewhere)."""
    sc = Scene(capacity=8)
    sc.add_triangle((-1, -1, -2), (1, -1, -2), (0, 1, -2))  # flat
    sc.add_triangle((10, -1, -2), (12, -1, -2), (11, 1, -2),
                    normals=[(0, 0, 1)] * 3)  # smooth, off-axis
    org = np.array([[0.0, -0.2, 0.0]], np.float32)
    dirn = np.array([[0.0, 0.0, -1.0]], np.float32)
    hit, t, idx = isect.hit_scene(
        org, dirn, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2)
    rec = isect.make_hit_record(
        org, dirn, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2,
        uv0=sc.uv0, uv1=sc.uv1, uv2=sc.uv2,
        vnorm0=sc.vnorm0, vnorm1=sc.vnorm1, vnorm2=sc.vnorm2)
    assert bool(np.asarray(hit)[0])
    np.testing.assert_allclose(
        np.asarray(rec.normal)[0], (0, 0, 1), atol=1e-6)


# -------------------------------------------------------------- mesh lib
def test_vertex_normals_area_weighted():
    v, f = mesh.icosphere(1)
    vn = mesh.vertex_normals(v, f)
    np.testing.assert_allclose(np.linalg.norm(vn, axis=1), 1.0, atol=1e-6)
    # icosphere vertex normals point radially outward (symmetry)
    cos = np.sum(vn * v, axis=1)
    assert cos.min() > 0.99


def test_obj_round_trip_with_attrs(tmp_path):
    v, f = mesh.box()
    vn = mesh.vertex_normals(v, f)
    uv = RNG.uniform(0, 1, (len(v), 2)).astype(np.float32)
    p = str(tmp_path / "m.obj")
    mesh.save_obj(p, v, f, uvs=uv, normals=vn)
    m = mesh.load_obj_full(p)
    np.testing.assert_allclose(m.vertices, v, atol=1e-5)
    np.testing.assert_array_equal(m.faces, f)
    np.testing.assert_allclose(m.uvs, uv, atol=1e-5)
    np.testing.assert_array_equal(m.uv_faces, f)
    np.testing.assert_allclose(m.normals, vn, atol=1e-5)
    np.testing.assert_array_equal(m.normal_faces, f)
    # geometry-only reader still works on the attributed file
    v2, f2 = mesh.load_obj(p)
    np.testing.assert_allclose(v2, v, atol=1e-5)


def test_obj_v_vt_and_v_vn_forms(tmp_path):
    p = str(tmp_path / "forms.obj")
    with open(p, "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "vn 0 0 1\n"
                 "f 1//1 2//1 3//1\n")
    m = mesh.load_obj_full(p)
    assert m.uvs is None
    np.testing.assert_allclose(m.normals, [(0, 0, 1)], atol=1e-6)
    np.testing.assert_array_equal(m.normal_faces, [(0, 0, 0)])


def test_scene_persistence_with_attrs(tmp_path):
    sc = Scene(capacity=16)
    uv = np.array([(0.1, 0.2), (0.8, 0.1), (0.3, 0.9)], np.float32)
    vn = np.array([(0, 0, 1), (0, 1, 0), (1, 0, 0)], np.float32)
    sc.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), uv=uv, normals=vn)
    sc.add_triangle((2, 0, 0), (3, 0, 0), (2, 1, 0))  # plain
    p = str(tmp_path / "s.json")
    sc.save(p)
    sc2 = Scene.load(p)
    assert sc2.has_vertex_attrs
    i = [j for j in sc2.active_indices()
         if (sc2.vnorm0[j] != 0).any()][0]
    np.testing.assert_allclose(
        np.stack([sc2.uv0[i], sc2.uv1[i], sc2.uv2[i]]), uv, atol=1e-6)
    np.testing.assert_allclose(
        np.stack([sc2.vnorm0[i], sc2.vnorm1[i], sc2.vnorm2[i]]), vn,
        atol=1e-6)
    plain = [j for j in sc2.active_indices() if j != i][0]
    assert not (sc2.vnorm0[plain] != 0).any()


# ------------------------------------------------------------ end-to-end


@pytest.mark.slow
def test_smooth_mesh_renders_brute_and_bvh():
    """Smooth icosphere renders on brute and BVH paths identically, and
    differs from the flat-shaded render (the feature is visible)."""
    v, f = mesh.icosphere(1)
    cam = make_camera_params(origin=(0, 0.3, 2.4), forward=(0, -0.1, -1))
    key = rngu.base_key(9)

    def build(smooth):
        sc = Scene(capacity=128)
        sc.add_sphere((0, -100.7, -1), 100.0, albedo=(0.6, 0.6, 0.6))
        sc.add_mesh(mesh.transformed(v, translate=(0, 0, -0.5)), f,
                    normals=v if smooth else None,
                    albedo=(0.8, 0.4, 0.2), mat_type=1, fuzz=0.05)
        return sc

    sc = build(True)
    sd = sc.device()
    r = Renderer(48, 36, camera_model="look_at", accel="brute")
    img_b = np.asarray(r.render(sd, cam, key, spp=4, max_depth=5)) / 4.0
    bvh = bvhm.build_bvh(sc)
    r2 = Renderer(48, 36, camera_model="look_at", accel="bvh")
    img_v = np.asarray(r2.render(sd, cam, key, spp=4, max_depth=5,
                                 bvh=bvh)) / 4.0
    np.testing.assert_allclose(img_b, img_v, atol=1e-4)

    flat = build(False).device()
    img_f = np.asarray(r.render(flat, cam, key, spp=4, max_depth=5)) / 4.0
    assert np.abs(img_b - img_f).max() > 0.05  # shading visibly differs


def test_bvh_kernel_textured_mesh_exact_interior():
    """Image texture on a UV-mapped mesh through the BVH path with the
    closest-hit kernel (interpreted): pixels strictly inside a
    constant-color image region must match the brute XLA path EXACTLY
    (same texel, emission-terminated paths)."""
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn
    from cudaraytracer_tpu.models.renderer import render_radiance
    from cudaraytracer_tpu.models.scene import DIFFUSE_LIGHT

    # 2x2 pure-color quadrants (no gradients): away from the quadrant
    # seams every jittered sample in a pixel lands on the same texel
    img = np.zeros((64, 64, 3), np.uint8)
    img[:32, :32] = (255, 40, 40)
    img[:32, 32:] = (40, 255, 40)
    img[32:, :32] = (40, 40, 255)
    img[32:, 32:] = (250, 250, 60)

    sc = Scene(capacity=16, background_start=(0, 0, 0),
               background_end=(0, 0, 0))
    slot = sc.load_image_texture(img)
    v = np.array([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)], np.float32)
    uv = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    f = np.array([(0, 1, 2), (0, 2, 3)], np.int64)
    sc.add_mesh(v, f, uvs=uv, mat_type=DIFFUSE_LIGHT, light=2.0,
                tex_type=2, tex_id=slot)
    sd = sc.device()
    cam = make_camera_params(origin=(0, 0, 1.6), forward=(0, 0, -1))
    W, H, DEPTH = 32, 16, 3
    kw = dict(width=W, height=H, camera_model="look_at")

    got = np.asarray(render_radiance(
        sd, cam, rngu.base_key(3), 1, DEPTH, **kw,
        hit_fn=make_bvh_hit_fn(build_bvh(sc), sd, traversal="interpret")))
    xla = np.asarray(render_radiance(sd, cam, rngu.base_key(2), 1, DEPTH,
                                     **kw))

    # interior mask: pixels whose 3x3 XLA neighborhood is constant (the
    # two renders use different keys: only the texel, not the jitter,
    # may decide an interior pixel)
    const = np.ones((H, W), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(np.roll(xla, dy, 0), dx, 1)
            const &= (np.abs(shifted - xla) < 1e-6).all(-1)
    const[[0, -1], :] = False
    const[:, [0, -1]] = False
    assert const.sum() > H * W * 0.3  # plenty of interior
    assert np.abs(got[const] - xla[const]).max() < 1e-5
    # all four quadrant colors actually appear
    assert len({tuple(np.round(c, 3)) for c in got[const]}) >= 4
