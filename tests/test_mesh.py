"""Triangle primitive + mesh subsystem tests (BEYOND-REFERENCE).

The reference supports only spheres and axis-aligned rects
(CudaRayTracer/src/Hittables/Hittable.cuh:30-38); triangles/meshes are an
addition.  Coverage: Moller-Trumbore vs a scalar oracle, brute == BVH
agreement on mixed scenes, hit-record normals/barycentrics, mesh
generators' invariants, OBJ round-trip, scene persistence, and an
end-to-end render.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from cudaraytracer_tpu.models import bvh as bvhm
from cudaraytracer_tpu.models.scene import Scene
from cudaraytracer_tpu.ops import intersect as isect
from cudaraytracer_tpu.utils import mesh

RNG = np.random.RandomState(7)
BIG = 3.4e38


# ---------------------------------------------------------------- oracle
def tri_hit_oracle(o, d, v0, v1, v2, t_min, t_max):
    """Scalar Moller-Trumbore (classic direct form)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pv = np.cross(d, e2)
    det = e1 @ pv
    if abs(det) <= 1e-9:
        return None
    inv = 1.0 / det
    tv = o - v0
    u = (tv @ pv) * inv
    if u < 0.0:
        return None
    qv = np.cross(tv, e1)
    v = (d @ qv) * inv
    if v < 0.0 or u + v > 1.0:
        return None
    t = (e2 @ qv) * inv
    if not (t_min < t < t_max):
        return None
    return t


def random_tri_scene(n=24, tri_frac=0.5):
    """Mixed scene: triangles + spheres + rects."""
    sc = Scene(capacity=64)
    for i in range(n):
        if RNG.rand() < tri_frac:
            v0 = RNG.uniform(-3, 3, 3).astype(np.float32)
            v1 = v0 + RNG.uniform(-1.5, 1.5, 3).astype(np.float32)
            v2 = v0 + RNG.uniform(-1.5, 1.5, 3).astype(np.float32)
            sc.add_triangle(v0, v1, v2, albedo=(0.5, 0.5, 0.5))
        elif RNG.rand() < 0.5:
            sc.add_sphere(RNG.uniform(-3, 3, 3), float(RNG.uniform(0.3, 1.0)),
                          albedo=(0.5, 0.5, 0.5))
        else:
            add = [sc.add_xy_rect, sc.add_xz_rect, sc.add_yz_rect][RNG.randint(3)]
            add(RNG.uniform(-3, 3, 3), float(RNG.uniform(0.5, 2.0)),
                float(RNG.uniform(0.5, 2.0)), albedo=(0.5, 0.5, 0.5))
    return sc


def random_rays(r=64):
    o = RNG.uniform(-5, 5, (r, 3)).astype(np.float32)
    d = RNG.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def scene_oracle_t(sc, o, d, t_min=1e-3):
    """Closest hit over a Scene incl. triangles, scalar oracle."""
    from test_intersect import rect_hit_oracle, sphere_hit_oracle

    best_t, best_i = BIG, -1
    for i in sc.active_indices():
        pt = int(sc.prim_type[i])
        if pt == 0:
            t = sphere_hit_oracle(o, d, sc.center[i], sc.size[i][0], t_min, best_t)
        elif pt == isect.TRIANGLE:
            v0 = sc.center[i]
            t = tri_hit_oracle(o, d, v0, v0 + sc.edge1[i], v0 + sc.edge2[i],
                               t_min, best_t)
        else:
            t = rect_hit_oracle(o, d, pt, sc.center[i], sc.size[i], t_min, best_t)
        if t is not None and t < best_t:
            best_t, best_i = t, i
    return (best_i >= 0), best_t, best_i


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("block", [8, 64])
def test_hit_scene_triangles_match_oracle(block):
    sc = random_tri_scene(24)
    o, d = random_rays(60)
    hit, t, idx = isect.hit_scene(
        o, d, sc.prim_type, sc.center, sc.size, sc.active,
        block=block, edge1=sc.edge1, edge2=sc.edge2,
    )
    hit, t, idx = np.asarray(hit), np.asarray(t), np.asarray(idx)
    for r in range(len(o)):
        oh, ot, oi = scene_oracle_t(sc, o[r], d[r])
        assert hit[r] == oh, r
        if oh:
            assert idx[r] == oi, (r, idx[r], oi)
            np.testing.assert_allclose(t[r], ot, rtol=2e-4)


def test_bvh_matches_brute_on_triangles():
    sc = random_tri_scene(30)
    o, d = random_rays(80)
    sd = sc.device()
    hit_b, t_b, idx_b = isect.hit_scene(
        o, d, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2,
    )
    bvh = bvhm.build_bvh(sc)
    fn = bvhm.make_bvh_hit_fn(bvh, sd)
    hit_v, t_v, idx_v = fn(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(hit_b), np.asarray(hit_v))
    np.testing.assert_array_equal(
        np.asarray(idx_b)[np.asarray(hit_b)], np.asarray(idx_v)[np.asarray(hit_b)]
    )
    np.testing.assert_allclose(
        np.asarray(t_b)[np.asarray(hit_b)], np.asarray(t_v)[np.asarray(hit_b)],
        rtol=2e-5,
    )


@pytest.mark.slow
def test_triangle_hit_record_normal_and_barycentrics():
    sc = Scene(capacity=8)
    # right triangle in the z=1 plane: v0 origin, e1 = +x, e2 = +y
    sc.add_triangle((0, 0, 1), (2, 0, 1), (0, 2, 1), albedo=(1, 1, 1))
    # rays from below (-z side) and above hit the two faces
    o = np.array([[0.5, 0.5, 0.0], [0.5, 0.25, 2.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    hit, t, idx = isect.hit_scene(
        o, d, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2,
    )
    rec = isect.make_hit_record(
        o, d, hit, t, idx, sc.prim_type, sc.center, sc.size,
        edge1=sc.edge1, edge2=sc.edge2,
    )
    assert np.asarray(hit).all()
    np.testing.assert_allclose(np.asarray(t), [1.0, 1.0], atol=1e-6)
    n = np.asarray(rec.normal)
    # two-sided: normal faces the incoming ray (SetFaceNormal semantics)
    np.testing.assert_allclose(n[0], [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(n[1], [0, 0, 1], atol=1e-6)
    # barycentric (u, v) wrt (e1, e2): p = v0 + u e1 + v e2
    u = np.asarray(rec.u)
    v = np.asarray(rec.v)
    np.testing.assert_allclose(u, [0.25, 0.25], atol=1e-5)
    np.testing.assert_allclose(v, [0.25, 0.125], atol=1e-5)
    front = np.asarray(rec.front_face)
    assert front[1] and not front[0]


def test_triangle_degenerate_and_parallel_rays():
    sc = Scene(capacity=4)
    sc.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), albedo=(1, 1, 1))
    # ray parallel to the triangle plane, and a ray missing outside the edge
    o = np.array([[-1, 0.2, 0.0], [5, 5, -1]], np.float32)
    d = np.array([[1, 0, 0], [0, 0, 1]], np.float32)
    hit, _, _ = isect.hit_scene(
        o, d, sc.prim_type, sc.center, sc.size, sc.active,
        edge1=sc.edge1, edge2=sc.edge2,
    )
    assert not np.asarray(hit).any()


# ----------------------------------------------------------- mesh library
def test_icosphere_invariants():
    for sub, nf in [(0, 20), (1, 80), (2, 320)]:
        v, f = mesh.icosphere(sub)
        assert f.shape == (nf, 3)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-6)
        # CCW outward: face normal aligns with face centroid direction
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        n = np.cross(e1, e2)
        cent = v[f].mean(axis=1)
        assert (np.einsum("ij,ij->i", n, cent) > 0).all()


def test_torus_and_box_outward_normals():
    v, f = mesh.box((2.0, 1.0, 3.0))
    assert f.shape == (12, 3)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    cent = v[f].mean(axis=1)
    assert (np.einsum("ij,ij->i", n, cent) > 0).all()

    v, f = mesh.torus(1.0, 0.3, segments=12, sides=6)
    assert len(f) == 12 * 6 * 2
    # outward wrt the tube center circle
    cent = v[f].mean(axis=1)
    ring = cent.copy()
    ring[:, 1] = 0.0
    ring /= np.maximum(np.linalg.norm(ring, axis=1, keepdims=True), 1e-9)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    tube = cent - ring  # from tube-center circle to the face centroid
    assert (np.einsum("ij,ij->i", n, tube) > 0).mean() > 0.95


def test_transformed():
    v = np.array([[1.0, 0.0, 0.0]], np.float32)
    out = mesh.transformed(v, scale=2.0, rotate_y=math.pi / 2, translate=(0, 5, 0))
    np.testing.assert_allclose(out, [[0.0, 5.0, -2.0]], atol=1e-6)


def test_obj_round_trip(tmp_path):
    v, f = mesh.icosphere(1)
    p = str(tmp_path / "m.obj")
    mesh.save_obj(p, v, f)
    v2, f2 = mesh.load_obj(p)
    np.testing.assert_allclose(v, v2, atol=1e-6)
    np.testing.assert_array_equal(f, f2)


def test_obj_quads_and_negative_indices(tmp_path):
    p = str(tmp_path / "q.obj")
    with open(p, "w") as fh:
        fh.write("# quad + neg idx\n")
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
        fh.write("f 1/1/1 2/2/2 3/3/3 4/4/4\n")  # quad, with /vt/vn junk
        fh.write("f -4 -3 -2\n")
    v, f = mesh.load_obj(p)
    assert v.shape == (4, 3)
    # quad fan-triangulates to 2 faces + 1 more from the negative-index face
    np.testing.assert_array_equal(f, [(0, 1, 2), (0, 2, 3), (0, 1, 2)])


def test_scene_add_mesh_and_persistence(tmp_path):
    sc = Scene(capacity=128)
    v, f = mesh.icosphere(1)
    ids = sc.add_mesh(mesh.transformed(v, scale=0.5, translate=(0, 1, 0)), f,
                      albedo=(0.8, 0.3, 0.2))
    assert len(ids) == 80
    assert sc.num_triangles == 80
    sd = sc.device()
    assert sd.has_triangles
    p = str(tmp_path / "scene.json")
    sc.save(p)
    sc2 = Scene.load(p)
    np.testing.assert_allclose(sc.edge1[:100], sc2.edge1[:100], atol=1e-7)
    np.testing.assert_allclose(sc.edge2[:100], sc2.edge2[:100], atol=1e-7)
    assert sc2.num_triangles == 80
    # delete + free-list recycle works for triangles too
    sc.delete(ids[0])
    assert sc.num_triangles == 79


def test_transform_mesh_rotate_scale():
    """transform_mesh: scale/rotation about the group centroid transforms
    vertices, edges AND vertex normals; flat sentinels and uvs survive."""
    sc = Scene(capacity=32)
    v = np.array([(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)], np.float32)
    f = np.array([(0, 1, 2), (0, 2, 3)], np.int64)
    uvs = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    vns = np.array([(0, 0, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1)], np.float32)
    ids = sc.add_mesh(v, f, uvs=uvs, normals=vns)
    mid = int(sc.mesh_id[ids[0]])
    # a second FLAT mesh: its zero-vnorm sentinel must survive rotation
    ids2 = sc.add_mesh(v + (5, 0, 0), f)
    mid2 = int(sc.mesh_id[ids2[0]])

    def pts(ix):
        v0 = sc.center[ix]
        return np.concatenate([v0, v0 + sc.edge1[ix], v0 + sc.edge2[ix]])

    idx = sc.mesh_indices(mid)
    p0 = pts(idx)
    ctr = p0.mean(0)
    uv_before = sc.uv0[idx].copy()
    ver = sc.version

    sc.transform_mesh(mid, scale=3.0)
    p1 = pts(idx)
    np.testing.assert_allclose(p1, (p0 - ctr) * 3.0 + ctr, atol=1e-5)
    # uniform scale: normals and uvs untouched
    np.testing.assert_allclose(sc.vnorm0[idx][0], (0, 0, 1), atol=1e-6)
    np.testing.assert_allclose(sc.uv0[idx], uv_before, atol=1e-7)
    assert sc.version > ver

    sc.transform_mesh(mid, rotate_y=np.pi / 2)
    p2 = pts(idx)
    # y-rotation convention of utils.mesh.transformed: (x,y,z)->(z,y,-x)
    rel = p1 - p2.mean(0)
    want = np.stack([rel[:, 2], rel[:, 1], -rel[:, 0]], 1) + p2.mean(0)
    np.testing.assert_allclose(p2, want, atol=1e-4)
    np.testing.assert_allclose(p2.mean(0), p1.mean(0), atol=1e-5)
    # vertex normals rotate with the geometry: (1,0,0) -> (0,0,-1)
    np.testing.assert_allclose(sc.vnorm1[idx][0], (0, 0, -1), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(sc.vnorm0[idx], axis=1), 1.0,
                               atol=1e-6)

    sc.transform_mesh(mid2, rotate_y=1.0)
    assert (sc.vnorm0[sc.mesh_indices(mid2)] == 0.0).all()  # still flat


def test_mesh_grouping_and_group_edits(tmp_path):
    """add_mesh assigns one group id per mesh; group edits fan out; a
    recycled slot never inherits the old group; save/load keeps groups."""
    sc = Scene(capacity=64)
    sc.add_sphere((0, 0, 0), 1.0)
    v, f = mesh.box((1, 1, 1))
    ids_a = sc.add_mesh(v, f, albedo=(0.8, 0.2, 0.2))
    ids_b = sc.add_mesh(mesh.transformed(v, translate=(3, 0, 0)), f)
    assert sc.mesh_group_ids() == [0, 1]
    assert set(sc.mesh_indices(0)) == set(ids_a)
    assert int(sc.mesh_id[0]) == -1  # the sphere is standalone

    from cudaraytracer_tpu.models.scene import METAL

    sc.update_mesh(1, mat_type=METAL, fuzz=0.3)
    assert (sc.mat_type[ids_b] == METAL).all()
    assert (sc.fuzz[ids_b] == np.float32(0.3)).all()
    assert (sc.mat_type[ids_a] != METAL).all()

    p = str(tmp_path / "grouped.json")
    sc.save(p)
    sc2 = Scene.load(p)
    assert sc2.mesh_group_ids() == [0, 1]
    assert len(sc2.mesh_indices(1)) == len(ids_b)
    # the loaded scene's next group id never collides with a loaded group
    sc2.add_mesh(mesh.transformed(v, translate=(6, 0, 0)), f)
    assert sc2.mesh_group_ids() == [0, 1, 2]

    sc.delete_mesh(0)
    assert sc.mesh_group_ids() == [1]
    # recycled slots come back standalone
    j = sc.add_sphere((1, 1, 1), 0.5)
    assert j in ids_a and int(sc.mesh_id[j]) == -1
    with pytest.raises(ValueError):
        sc.delete_mesh(0)

    # capacity growth preserves group membership
    sc3 = Scene(capacity=8)
    gids = sc3.add_mesh(v, f)  # 12 tris force a growth past 8 slots
    assert sc3.capacity > 8
    assert set(sc3.mesh_indices(0)) == set(gids)
    assert (sc3.mesh_id[~sc3.active] == -1).all()


@pytest.mark.slow
def test_mesh_scene_renders_brute_and_bvh():
    from cudaraytracer_tpu.models.camera import make_camera_params
    from cudaraytracer_tpu.models.renderer import Renderer
    from cudaraytracer_tpu.utils import rng as rngu

    sc = Scene(capacity=64)
    sc.add_sphere((0, -100.5, -1), 100.0, albedo=(0.6, 0.6, 0.6))
    v, f = mesh.box((1.0, 1.0, 1.0))
    sc.add_mesh(mesh.transformed(v, rotate_y=0.4, translate=(0, 0, -1.5)), f,
                albedo=(0.8, 0.2, 0.2))
    sd = sc.device()
    cam = make_camera_params(origin=(0, 0.4, 1.5), forward=(0, -0.15, -1))
    key = rngu.base_key(3)

    r = Renderer(64, 48, camera_model="look_at", accel="brute")
    img_b = np.asarray(r.render(sd, cam, key, spp=4, max_depth=6)) / 4.0
    bvh = bvhm.build_bvh(sc)
    r2 = Renderer(64, 48, camera_model="look_at", accel="bvh")
    img_v = np.asarray(r2.render(sd, cam, key, spp=4, max_depth=6, bvh=bvh)) / 4.0
    # same RNG stream + exact same intersection results -> near-identical
    np.testing.assert_allclose(img_b, img_v, atol=1e-4)
    # the box is visible: center rows differ from the sky/ground-only edges
    assert img_b.std() > 0.01


def test_bulk_add_mesh_matches_per_face_add_triangle():
    """add_mesh's vectorized bulk insert must be bit-identical to F
    sequential add_triangle calls (same slot order, same defaults, same
    validation) — table packing and save/load depend on it."""
    from cudaraytracer_tpu.models.scene import METAL, Scene

    v, f = mesh.icosphere(1)
    rng = np.random.RandomState(0)
    uv = rng.rand(len(v), 2).astype(np.float32)
    nrm = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)

    s_bulk = Scene(capacity=128)
    s_bulk.add_mesh(v, f, uvs=uv, normals=nrm, mat_type=METAL,
                    albedo=(0.8, 0.7, 0.6), fuzz=0.1)
    s_loop = Scene(capacity=128)
    ids = []
    for (a, b, c) in f:
        ids.append(s_loop.add_triangle(
            v[a], v[b], v[c], uv=uv[[a, b, c]], normals=nrm[[a, b, c]],
            mat_type=METAL, albedo=(0.8, 0.7, 0.6), fuzz=0.1))
    s_loop.mesh_id[ids] = 0

    for name in ("prim_type", "active", "center", "size", "mat_type",
                 "fuzz", "ior", "light", "tex_type", "albedo", "albedo2",
                 "tex_id", "edge1", "edge2", "uv0", "uv1", "uv2",
                 "vnorm0", "vnorm1", "vnorm2", "mesh_id"):
        assert np.array_equal(getattr(s_bulk, name),
                              getattr(s_loop, name)), name


def test_bulk_add_mesh_grows_and_validates():
    from cudaraytracer_tpu.models.scene import Scene

    v, f = mesh.icosphere(1)  # 80 faces
    sc = Scene(capacity=16)
    sc.add_mesh(v, f)  # forces capacity growth mid-insert
    assert sc.num_active == len(f)
    assert sc.capacity >= len(f)
    import pytest as _pytest

    with _pytest.raises(ValueError):
        sc.add_mesh(v, f, normals=np.zeros_like(v))  # zero-length normals
    bad_uv = np.zeros((len(v), 3), np.float32)  # wrong trailing dim
    with _pytest.raises((ValueError, IndexError)):
        sc.add_mesh(v, f, uvs=bad_uv)


def test_large_mesh_scene_routes_to_bvh():
    """A terrain_big-style mesh (5,000 triangles) opens on the BVH path
    under accel=auto — the tree, not a brute scan, carries large scenes —
    and renders a finite, lit frame."""
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.models import scenes as scn
    from cudaraytracer_tpu.viewer.app import Application, RenderLayer

    sc = scn.terrain_big_scene(capacity=8192, n=51)
    assert sc.num_active == 5002
    cfg = RenderConfig(width=16, height=8, max_depth=2, scene="terrain_big",
                       accel="auto", camera_model="look_at")
    app = Application(cfg)
    rl = RenderLayer(cfg, scene=sc)
    rl._pose_fly_at(scn.terrain_camera())
    app.push_layer(rl)
    app.run(max_frames=1)
    assert rl.cfg.accel == "bvh" and rl._bvh is not None
    assert int(rl._bvh.n_nodes) == 2 * sc.num_active - 1
    img = rl.radiance_mean()
    assert np.isfinite(img).all() and img.mean() > 0.01
    app.close()


@pytest.mark.parametrize("name", ["mesh_demo", "mesh_smooth", "terrain"])
def test_mesh_scene_bvh_kernel_matches_brute_render(name):
    """Same RNG stream through the BVH path with the closest-hit kernel
    (interpreted) and through the brute reference: identical hits, so the
    frames agree to float noise."""
    from cudaraytracer_tpu.models import scenes as scn
    from cudaraytracer_tpu.models.renderer import render_radiance
    from cudaraytracer_tpu.utils import rng as rngu

    make_scene, make_cam = scn.SCENES[name]
    sc = make_scene()
    sd = sc.device()
    kw = dict(width=8, height=8, camera_model="look_at")
    key = rngu.base_key(4)
    ref = np.asarray(render_radiance(sd, make_cam(), key, 1, 3, **kw))
    got = np.asarray(render_radiance(
        sd, make_cam(), key, 1, 3, **kw,
        hit_fn=bvhm.make_bvh_hit_fn(bvhm.build_bvh(sc), sd,
                                    traversal="interpret")))
    np.testing.assert_allclose(got, ref, atol=2e-3)
