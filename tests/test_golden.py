"""Golden statistical test: JAX renderer vs the scalar NumPy oracle.

Different RNG streams mean per-pixel values differ; the renderers must
agree in expectation, so we compare block-averaged images (the
pixel-statistical-match requirement of BASELINE.json's north star).
"""

import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.utils import rng as rngu

import oracle


def test_default_scene_matches_oracle():
    W, H, SPP, DEPTH = 24, 16, 12, 6
    scene = scenes.default_scene()
    cam_origin = (0.0, 2.0, 12.0)
    forward = (0.0, 0.0, -1.0)

    gold = oracle.render(scene, cam_origin, forward, W, H, SPP, DEPTH, seed=5)

    sd = scene.device()
    cam = scenes.default_scene_camera()
    ours = np.asarray(
        render_radiance(sd, cam, rngu.base_key(), SPP * 2, DEPTH, width=W, height=H)
    ) / (SPP * 2)

    # whole-image channel means agree
    np.testing.assert_allclose(ours.mean((0, 1)), gold.mean((0, 1)), atol=0.04)
    # 4x4 block means agree everywhere (loose: Monte-Carlo noise at this spp)
    blk_g = gold.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    blk_o = ours.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    err = np.abs(blk_g - blk_o)
    assert err.mean() < 0.05, f"mean block error {err.mean()}"
    assert err.max() < 0.35, f"max block error {err.max()}"


def test_emissive_scene_matches_oracle():
    from cudaraytracer_tpu.models.scene import DIFFUSE_LIGHT, LAMBERTIAN, METAL, Scene

    W, H, SPP, DEPTH = 16, 12, 16, 5
    scene = Scene(capacity=8, background_start=(0.02, 0.02, 0.02),
                  background_end=(0.02, 0.02, 0.02))
    scene.add_xz_rect((0, 0, 0), 40, 40, mat_type=LAMBERTIAN, albedo=(0.7, 0.7, 0.7))
    scene.add_sphere((0, 4, -3), 1.5, mat_type=DIFFUSE_LIGHT, albedo=(1, 1, 1), light=4.0)
    scene.add_sphere((0, 1, -3), 1.0, mat_type=METAL, albedo=(0.9, 0.9, 0.9), fuzz=0.1)

    cam_origin = (0.0, 2.0, 6.0)
    forward = (0.0, 0.0, -1.0)
    gold = oracle.render(scene, cam_origin, forward, W, H, SPP, DEPTH, seed=11)

    from cudaraytracer_tpu.models.camera import make_camera_params

    sd = scene.device()
    cam = make_camera_params(origin=cam_origin, forward=forward)
    ours = np.asarray(
        render_radiance(sd, cam, rngu.base_key(), SPP * 2, DEPTH, width=W, height=H)
    ) / (SPP * 2)

    np.testing.assert_allclose(ours.mean((0, 1)), gold.mean((0, 1)), atol=0.05)


@pytest.mark.slow
def test_mesh_scene_matches_oracle():
    """Triangle meshes against the scalar golden model: a smooth-shaded
    lambertian icosphere and a flat metal tetrahedron over the ground,
    rendered through the look_at camera — block means must agree with the
    oracle's scalar Möller–Trumbore + interpolated-normal path."""
    from cudaraytracer_tpu.models.camera import make_camera_params
    from cudaraytracer_tpu.models.scene import LAMBERTIAN, METAL, Scene
    from cudaraytracer_tpu.utils import mesh

    W, H, SPP, DEPTH = 24, 16, 16, 5
    sc = Scene(capacity=64)
    sc.add_xz_rect((0, -0.5, 0), 30.0, 30.0, mat_type=LAMBERTIAN,
                   albedo=(0.5, 0.5, 0.5))
    v, f = mesh.icosphere(0)  # 20 coarse faces: smooth shading is visible
    sc.add_mesh(mesh.transformed(v, scale=0.55, translate=(-0.7, 0.1, -2.0)),
                f, normals=v, mat_type=LAMBERTIAN, albedo=(0.8, 0.3, 0.25))
    tet = np.array([(0, 0, 0), (1, 0, 0), (0.5, 1.0, 0.3), (0.4, 0.1, 1.0)],
                   np.float32)
    tf = np.array([(0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2)], np.int64)
    sc.add_mesh(mesh.transformed(tet, scale=0.9, translate=(0.5, -0.4, -2.2)),
                tf, mat_type=METAL, albedo=(0.8, 0.8, 0.6), fuzz=0.1)

    origin, forward, fov = (0.0, 0.6, 0.9), (0.0, -0.25, -1.0), 55.0
    gold = oracle.render_look_at(sc, origin, forward, W, H, SPP, DEPTH,
                                 seed=9, fov_deg=fov)
    cam = make_camera_params(origin=origin, forward=forward, fov_deg=fov)
    ours = np.asarray(
        render_radiance(sc.device(), cam, rngu.base_key(), SPP * 2, DEPTH,
                        width=W, height=H, camera_model="look_at")
    ) / (SPP * 2)

    np.testing.assert_allclose(ours.mean((0, 1)), gold.mean((0, 1)), atol=0.04)
    blk_g = gold.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    blk_o = ours.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    err = np.abs(blk_g - blk_o)
    assert err.mean() < 0.05, f"mean block error {err.mean()}"
    assert err.max() < 0.35, f"max block error {err.max()}"

    # the smooth icosphere really shades smoothly in the ORACLE too:
    # flat-normal variant differs visibly (guards the oracle's own path)
    sc_flat = Scene(capacity=64)
    sc_flat.add_xz_rect((0, -0.5, 0), 30.0, 30.0, mat_type=LAMBERTIAN,
                        albedo=(0.5, 0.5, 0.5))
    sc_flat.add_mesh(
        mesh.transformed(v, scale=0.55, translate=(-0.7, 0.1, -2.0)), f,
        mat_type=LAMBERTIAN, albedo=(0.8, 0.3, 0.25))
    gold_flat = oracle.render_look_at(sc_flat, origin, forward, W, H, SPP,
                                      DEPTH, seed=9, fov_deg=fov)
    assert np.abs(gold - gold_flat).max() > 0.05


def test_image_texture_matches_oracle_exact_interior():
    """Image textures against the ORACLE (independent of the XLA path the
    other image tests compare to): an emissive quadrant-textured rect on a
    black background terminates every path at the first hit, so interior
    pixels (where every jittered sample lands on one texel) must match the
    scalar golden model exactly."""
    from cudaraytracer_tpu.models.camera import make_camera_params
    from cudaraytracer_tpu.models.scene import DIFFUSE_LIGHT, IMAGE, Scene

    img = np.zeros((64, 64, 3), np.uint8)
    img[:32, :32] = (255, 40, 40)
    img[:32, 32:] = (40, 255, 40)
    img[32:, :32] = (40, 40, 255)
    img[32:, 32:] = (250, 250, 60)

    sc = Scene(capacity=8, background_start=(0, 0, 0),
               background_end=(0, 0, 0))
    slot = sc.load_image_texture(img)
    sc.add_xy_rect((0, 0, -2), 2.0, 2.0, mat_type=DIFFUSE_LIGHT, light=2.0,
                   tex_type=IMAGE, tex_id=slot)

    W, H, DEPTH = 32, 24, 2
    origin, forward = (0.0, 0.0, 0.0), (0.0, 0.0, -1.0)
    gold = oracle.render_look_at(sc, origin, forward, W, H, 1, DEPTH,
                                 seed=3, fov_deg=60.0)
    cam = make_camera_params(origin=origin, forward=forward, fov_deg=60.0)
    ours = np.asarray(
        render_radiance(sc.device(), cam, rngu.base_key(5), 1, DEPTH,
                        width=W, height=H, camera_model="look_at"))

    # interior mask: 3x3-constant neighborhoods in BOTH renders
    def const_mask(a):
        m = np.ones((H, W), bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                sh = np.roll(np.roll(a, dy, 0), dx, 1)
                m &= (np.abs(sh - a) < 1e-6).all(-1)
        m[[0, -1], :] = False
        m[:, [0, -1]] = False
        return m

    interior = const_mask(gold) & const_mask(ours)
    assert interior.sum() > H * W * 0.3
    assert np.abs(gold[interior] - ours[interior]).max() < 1e-5
    # all four quadrant colors appear in the interior
    assert len({tuple(np.round(c, 3)) for c in ours[interior]}) >= 4


def test_look_at_camera_geometry():
    """Geometric golden test for the look_at camera (camera.py:90-116):
    a bright sphere at a known world position must project to the pixel
    predicted by independent pinhole math (s = 0.5 + x/(2 d tan(fov/2) a),
    t = 0.5 + y/(2 d tan(fov/2)); row 0 is the image top for look_at)."""
    import math

    from cudaraytracer_tpu.models.camera import make_camera_params
    from cudaraytracer_tpu.models.scene import DIFFUSE_LIGHT, Scene

    W, H, FOV = 64, 32, 60.0
    P = (2.0, 1.0, -10.0)
    scene = Scene(capacity=4, background_start=(0, 0, 0),
                  background_end=(0, 0, 0))
    scene.add_sphere(P, 0.4, mat_type=DIFFUSE_LIGHT, albedo=(1, 1, 1),
                     light=5.0)
    sd = scene.device()
    cam = make_camera_params(origin=(0.0, 0.0, 0.0), forward=(0.0, 0.0, -1.0),
                             fov_deg=FOV)
    img = np.asarray(
        render_radiance(sd, cam, rngu.base_key(), 8, 2, width=W, height=H,
                        camera_model="look_at")
    )
    half_h = math.tan(math.radians(FOV) / 2.0)
    half_w = (W / H) * half_h
    d = -P[2]
    s = 0.5 + P[0] / (2.0 * d * half_w)
    t = 0.5 + P[1] / (2.0 * d * half_h)
    exp_x = s * W
    exp_y = H - t * H  # look_at renders row 0 at the image top
    bright = img.sum(-1)
    cy, cx = np.unravel_index(np.argmax(bright), bright.shape)
    assert abs(cx - exp_x) <= 2.0, (cx, exp_x)
    assert abs(cy - exp_y) <= 2.0, (cy, exp_y)

