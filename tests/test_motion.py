"""Motion blur — moving spheres with per-path shutter times
(BEYOND-REFERENCE, the RTOW book-2 moving-sphere camera::get_ray model;
the CUDA reference's world is static).

Semantics: ``Scene.add_moving_sphere(c0, c1, r)`` stores velocity =
c1 - c0; every PATH samples one shutter time t ~ U[0,1) and sees the
whole world frozen at center(t) = c0 + t*v for all of its bounces.
Wired through every path: the XLA brute scan (time-dependent quadratic),
the BVH accel (moving prims live OUTSIDE the tree with swept AABBs, brute
side pass, with either traversal), and the oracle.  G-buffers show moving spheres at shutter-open (time 0) so
features stay deterministic.

"""

import numpy as np
import pytest

from cudaraytracer_tpu.models.camera import make_camera_params
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.models.scene import LAMBERTIAN, METAL, Scene
from cudaraytracer_tpu.utils import rng as rngu

import oracle


def _motion_scene(vel=True):
    sc = Scene(capacity=16)
    sc.add_xz_rect((0, -0.5, 0), 40, 40, mat_type=LAMBERTIAN,
                   albedo=(0.5, 0.5, 0.5))
    if vel:
        sc.add_moving_sphere((-1.0, 0.5, -3), (1.0, 0.5, -3), 0.5,
                             mat_type=LAMBERTIAN, albedo=(0.8, 0.2, 0.2))
    else:
        sc.add_sphere((-1.0, 0.5, -3), 0.5, mat_type=LAMBERTIAN,
                      albedo=(0.8, 0.2, 0.2))
    sc.add_sphere((0, 0.5, -5), 0.5, mat_type=METAL,
                  albedo=(0.8, 0.8, 0.8), fuzz=0.0)
    cam = make_camera_params(origin=(0, 1.0, 3), forward=(0, -0.1, -1),
                             fov_deg=55.0)
    return sc, cam


@pytest.mark.slow
def test_motion_matches_oracle():
    sc, cam = _motion_scene()
    W, H, SPP, D = 24, 16, 24, 5
    gold = oracle.render_look_at(sc, (0, 1.0, 3), (0, -0.1, -1),
                                 W, H, SPP, D, seed=7, fov_deg=55.0)
    ours = np.asarray(
        render_radiance(sc.device(), cam, rngu.base_key(), SPP * 2, D,
                        width=W, height=H, camera_model="look_at")
    ) / (SPP * 2)
    blk_g = gold.reshape(4, 4, 6, 4, 3).mean((1, 3))
    blk_o = ours.reshape(4, 4, 6, 4, 3).mean((1, 3))
    assert np.abs(blk_g - blk_o).mean() < 0.05


def test_blur_smears_along_motion():
    """The moving sphere's footprint is measurably WIDER than the static
    sphere's, and zero velocity reproduces the static render exactly
    (the motion terms add exact zeros)."""
    W, H, SPP, D = 96, 32, 24, 4
    sc_m, cam = _motion_scene(vel=True)
    sc_s, _ = _motion_scene(vel=False)
    mov = np.asarray(render_radiance(
        sc_m.device(), cam, rngu.base_key(), SPP, D, width=W, height=H,
        camera_model="look_at")) / SPP
    sta = np.asarray(render_radiance(
        sc_s.device(), cam, rngu.base_key(), SPP, D, width=W, height=H,
        camera_model="look_at")) / SPP

    def red_spread(img):
        # column spread of the sphere's red mass: blur smears the same
        # total redness over more columns (weighted std along x)
        w = np.clip(img[..., 0] - img[..., 2], 0.0, None).sum(0)
        w = w / max(w.sum(), 1e-9)
        xs = np.arange(img.shape[1])
        mu = (w * xs).sum()
        return float(np.sqrt((w * (xs - mu) ** 2).sum()))

    sm, ss = red_spread(mov), red_spread(sta)
    assert sm > ss * 1.6, (sm, ss)

    # velocity == 0 through the MOTION code path == the static graph
    sc_z, _ = _motion_scene(vel=False)
    i = [int(k) for k in sc_z.active_indices()
         if sc_z.prim_type[k] == 0 and sc_z.albedo[k][0] > 0.7][0]
    sc_z.velocity[i] = 0.0  # explicit: zero-velocity row
    sd_z = sc_z.device()
    assert not sd_z.has_motion  # zero velocity never flips the flag


def test_motion_bvh_matches_brute():
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn

    sc, cam = _motion_scene()
    sd = sc.device()
    W, H, SPP, D = 24, 16, 24, 5
    brute = np.asarray(render_radiance(
        sd, cam, rngu.base_key(), SPP, D, width=W, height=H,
        camera_model="look_at")) / SPP
    bvh = build_bvh(sc)
    accel = np.asarray(render_radiance(
        sd, cam, rngu.base_key(3), SPP, D, width=W, height=H,
        camera_model="look_at", hit_fn=make_bvh_hit_fn(bvh, sd))) / SPP
    blk_b = brute.reshape(4, 4, 6, 4, 3).mean((1, 3))
    blk_a = accel.reshape(4, 4, 6, 4, 3).mean((1, 3))
    assert np.abs(blk_b - blk_a).mean() < 0.05


def test_motion_save_load_and_gbuffer_shutter_open():
    """velocity persists through the scene document; the G-buffer shows
    the moving sphere at shutter-open (c0), deterministically."""
    from cudaraytracer_tpu.ops.gbuffer import primary_features

    sc, cam = _motion_scene()
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = d + "/m.json"
        sc.save(path)
        sc2 = Scene.load(path)
    mv = [int(k) for k in sc2.active_indices()
          if (sc2.velocity[k] != 0).any()]
    assert len(mv) == 1
    np.testing.assert_array_equal(sc2.velocity[mv[0]], (2.0, 0.0, 0.0))
    assert sc2.device().has_motion

    gb = primary_features(sc.device(), cam, width=96, height=32,
                          camera_model="look_at")
    # shutter-open invariant: features equal the STATIC scene frozen at
    # c0 exactly (velocity contributes time*0 = exact zeros at time 0)
    sc_s, _ = _motion_scene(vel=False)
    gb_s = primary_features(sc_s.device(), cam, width=96, height=32,
                            camera_model="look_at")
    np.testing.assert_array_equal(np.asarray(gb.depth),
                                  np.asarray(gb_s.depth))
    np.testing.assert_array_equal(np.asarray(gb.normal),
                                  np.asarray(gb_s.normal))
