"""The closest-hit kernel (ops/bvh_kernel.py) against the XLA traversal.

On the CPU the kernel runs through the Pallas interpreter (the Triton
route's semantics, not its code generation); its lowering to Triton IR is
checked separately by cross-lowering for CUDA, which needs no GPU.  The
compiled kernel is compared on the GPU by chip_smoke.py.

Tolerances: both traversals are f32 and walk the same tree in the same
order, so the hit primitive must agree on every ray here (no ties in these
ray sets) and t up to evaluation order (FMA contraction): |dt| <= 1e-4 *
max(t, 1) outside near-tangent hits on rtow_final's radius-1000 ground
sphere, whose discriminant cancels (chip_smoke.py T_REL_LOOSE).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.bvh import (build_bvh, make_bvh_hit_fn,
                                          resolve_traversal)
from cudaraytracer_tpu.models.camera import RAY_GENERATORS
from cudaraytracer_tpu.models.scene import Scene
from cudaraytracer_tpu.ops.bvh_kernel import (BLOCK_RAYS,
                                              bvh_closest_hit_kernel,
                                              pack_tables)
from cudaraytracer_tpu.ops.bvh_traverse import bvh_closest_hit

T_REL = 1e-4
T_REL_GRAZING = 2e-3


def _tri_kw(sd):
    return dict(edge1=sd.edge1, edge2=sd.edge2) if sd.has_triangles else {}


def _kernel(org, d, bvh, sd, **kw):
    tables = pack_tables(bvh, sd.prim_type, sd.center, sd.size, **_tri_kw(sd))
    return bvh_closest_hit_kernel(org, d, tables, **kw)


def _rays(kind, scene_name, sd, r=192):
    """camera: jittered primary rays of the registered camera; random:
    rays from points around the scene's bounds in uniform directions."""
    _, make_cam = scenes.SCENES[scene_name]
    if kind == "camera":
        org, d = RAY_GENERATORS[scenes.camera_model_for(scene_name)](
            make_cam(), 16, r // 16, jax.random.PRNGKey(5), y0=0,
            tile_h=r // 16)
        return org, d
    rng = np.random.default_rng(7)
    act = np.asarray(sd.active)
    c = np.asarray(sd.center)[act]
    lo, hi = np.percentile(c, 5, axis=0), np.percentile(c, 95, axis=0)
    org = lo + rng.random((r, 3)) * (hi - lo + 1e-3)
    d = rng.normal(size=(r, 3))
    return jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32)


def _assert_same(ref, got):
    h1, t1, p1 = (np.asarray(x) for x in ref)
    h2, t2, p2 = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(p1, p2)
    hit = h1
    rel = np.abs(t1 - t2)[hit] / np.maximum(np.abs(t1[hit]), 1.0)
    assert (rel <= T_REL).mean() >= 0.99 if rel.size else True
    assert (rel <= T_REL_GRAZING).all()


@pytest.mark.parametrize("rays", ["camera", "random"])
@pytest.mark.parametrize("name", ["default", "rtow_final", "cornell",
                                  "mesh_smooth", "terrain", "smoke",
                                  "bounce"])
def test_kernel_matches_xla_traversal(name, rays):
    make_scene, _ = scenes.SCENES[name]
    sc = make_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    org, d = _rays(rays, name, sd)
    ref = bvh_closest_hit(org, d, bvh, sd.prim_type, sd.center, sd.size,
                          **_tri_kw(sd))
    _assert_same(ref, _kernel(org, d, bvh, sd, interpret=True))


@pytest.mark.parametrize("r", [1, BLOCK_RAYS - 1, BLOCK_RAYS + 1,
                               9 * BLOCK_RAYS + 12])
def test_kernel_pads_ray_count(r):
    """Ray counts that are not a multiple of the block are padded and
    cropped; padding lanes never leak into the results."""
    sc = scenes.cornell_like_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    org, d = _rays("random", "cornell", sd, r=max(r, 16))
    org, d = org[:r], d[:r]
    got = _kernel(org, d, bvh, sd, interpret=True)
    assert all(x.shape == (r,) for x in got)
    _assert_same(bvh_closest_hit(org, d, bvh, sd.prim_type, sd.center,
                                 sd.size), got)


def test_kernel_empty_tree_misses():
    sc = Scene(capacity=4)
    sd, bvh = sc.device(), build_bvh(sc)
    assert int(bvh.n_nodes) == 0
    org = jnp.zeros((32, 3))
    d = jnp.ones((32, 3))
    hit, t, prim = _kernel(org, d, bvh, sd, interpret=True)
    assert not np.asarray(hit).any() and (np.asarray(prim) == -1).all()


def test_kernel_t_min_is_respected():
    """A ray starting on a sphere's surface must not re-hit it below t_min
    (the renderer's shadow-acne guard, Kernel.cu:40)."""
    sc = Scene(capacity=4)
    sc.add_sphere((0, 0, 0), 1.0)
    sd, bvh = sc.device(), build_bvh(sc)
    org = jnp.asarray([[1.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    hit, t, prim = _kernel(org, d, bvh, sd, t_min=1e-3, interpret=True)
    np.testing.assert_array_equal(np.asarray(hit), [False, True])
    np.testing.assert_allclose(np.asarray(t)[1], 2.0, rtol=1e-6)


@pytest.mark.parametrize("name", ["smoke", "bounce", "cornell_smoke"])
def test_kernel_hit_fn_with_media_and_motion(name):
    """make_bvh_hit_fn's XLA side pass (media, moving spheres) combines with
    the kernel exactly as with the XLA traversal."""
    make_scene, _ = scenes.SCENES[name]
    sc = make_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    org, d = _rays("camera", name, sd)
    r = org.shape[0]
    kw = dict(u_med=jax.random.uniform(jax.random.PRNGKey(1), (r,)),
              time=jax.random.uniform(jax.random.PRNGKey(2), (r,)))
    ref = make_bvh_hit_fn(bvh, sd, traversal="xla")(org, d, **kw)
    got = make_bvh_hit_fn(bvh, sd, traversal="interpret")(org, d, **kw)
    _assert_same(ref, got)


def test_resolve_traversal():
    assert resolve_traversal() == ("kernel" if jax.default_backend() == "gpu"
                                   else "xla")
    for t in ("kernel", "xla", "interpret"):
        assert resolve_traversal(t) == t
    with pytest.raises(ValueError):
        resolve_traversal("wavefront")


@pytest.mark.parametrize("has_tris", [False, True])
def test_kernel_lowers_to_triton_for_cuda(has_tris):
    """The Triton lowering (what the GPU compiles) accepts the kernel: a
    cross-platform lowering for CUDA, which needs no GPU.  PTX generation
    itself happens on the GPU (chip_smoke.py)."""
    name = "mesh_smooth" if has_tris else "rtow_final"
    make_scene, _ = scenes.SCENES[name]
    sc = make_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    assert sd.has_triangles == has_tris
    org = jnp.zeros((1000, 3))
    fn = jax.jit(lambda o, d: _kernel(o, d, bvh, sd))
    text = fn.trace(org, org).lower(lowering_platforms=("cuda",)).as_text()
    assert "bvh_closest_hit" in text


@pytest.mark.parametrize("name", ["rtow_final", "mesh_smooth"])
def test_pack_tables_layout(name):
    """The kernel's tables interleave the BVH's node arrays and the scene's
    primitive columns (triangle edges only when the scene has any)."""
    make_scene, _ = scenes.SCENES[name]
    sc = make_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    tb = pack_tables(bvh, sd.prim_type, sd.center, sd.size, **_tri_kw(sd))
    n = bvh.node_min.shape[0]
    node_f = np.asarray(tb.node_f).reshape(n, 6)
    node_i = np.asarray(tb.node_i).reshape(n, 2)
    np.testing.assert_array_equal(node_f[:, :3], bvh.node_min)
    np.testing.assert_array_equal(node_f[:, 3:], bvh.node_max)
    np.testing.assert_array_equal(node_i[:, 0], bvh.node_prim)
    np.testing.assert_array_equal(node_i[:, 1], bvh.node_skip)
    assert int(tb.n_nodes[0]) == int(bvh.n_nodes)
    prim_f = np.asarray(tb.prim_f)
    assert prim_f.shape[1] == (11 if sd.has_triangles else 5)
    np.testing.assert_array_equal(prim_f[:, :3], sd.center)
    np.testing.assert_array_equal(prim_f[:, 3:5], sd.size)
    if sd.has_triangles:
        np.testing.assert_array_equal(prim_f[:, 5:8], sd.edge1)
        np.testing.assert_array_equal(prim_f[:, 8:], sd.edge2)
