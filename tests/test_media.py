"""Constant-density participating media (smoke/fog) — BEYOND-REFERENCE.

The RTOW book-2 ConstantMedium analog (the CUDA reference has no
volumes): a sphere whose material is ISOTROPIC is a medium, not a
surface — rays entering it scatter isotropically at a distance sampled
from exp(-density * s).  Wired through every path: the XLA brute scan
(ops/intersect.py medium branch), the BVH accel (media live OUTSIDE the
tree, combined by closest hit — with either traversal, XLA or the
closest-hit kernel), the G-buffer (which sees through them), the oracle,
the scene registry ("smoke") and save/load.
"""

import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.camera import make_camera_params
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.models.scene import (DIFFUSE_LIGHT, ISOTROPIC,
                                            LAMBERTIAN, METAL, Scene)
from cudaraytracer_tpu.utils import rng as rngu

import oracle


def _small_smoke():
    sc = Scene(capacity=16, background_start=(0.05, 0.05, 0.07),
               background_end=(0.05, 0.05, 0.07))
    sc.add_xz_rect((0, -1, 0), 40, 40, mat_type=LAMBERTIAN,
                   albedo=(0.6, 0.6, 0.6))
    sc.add_sphere((0, 5, -3), 1.6, mat_type=DIFFUSE_LIGHT, light=5.0)
    sc.add_medium_sphere((0, 1.2, -3), 1.8, density=1.0,
                         albedo=(0.85, 0.85, 0.9))
    sc.add_sphere((0, 1.0, -3), 0.6, mat_type=METAL,
                  albedo=(0.9, 0.7, 0.4), fuzz=0.05)
    cam = make_camera_params(origin=(0.0, 1.8, 5.0),
                             forward=(0.0, -0.05, -1.0), fov_deg=55.0)
    return sc, cam


@pytest.mark.slow
def test_smoke_matches_oracle():
    """Fog-light scattering + an embedded metal sphere vs the scalar
    oracle's transliterated ConstantMedium (block means)."""
    sc, cam = _small_smoke()
    W, H, SPP, D = 24, 16, 16, 8
    gold = oracle.render_look_at(sc, (0.0, 1.8, 5.0), (0.0, -0.05, -1.0),
                                 W, H, SPP, D, seed=7, fov_deg=55.0)
    ours = np.asarray(
        render_radiance(sc.device(), cam, rngu.base_key(), SPP * 2, D,
                        width=W, height=H, camera_model="look_at")
    ) / (SPP * 2)
    np.testing.assert_allclose(ours.mean((0, 1)), gold.mean((0, 1)),
                               atol=0.05)
    blk_g = gold.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    blk_o = ours.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    assert np.abs(blk_g - blk_o).mean() < 0.05


def test_medium_limits():
    """Physical limits pin the sampling math: a near-zero-density medium
    is EXACTLY transparent (scatter distance -> inf), and an extremely
    dense one blocks like a surface shell (background never visible
    through its silhouette)."""
    W, H = 32, 24
    cam = make_camera_params(origin=(0, 0, 3), forward=(0, 0, -1),
                             fov_deg=60.0)
    bg = np.array([0.2, 0.3, 0.5], np.float32)
    sc = Scene(capacity=4, background_start=tuple(bg),
               background_end=tuple(bg))
    sc.add_medium_sphere((0, 0, -2), 1.2, density=1e-6, albedo=(1, 0, 0))
    thin = np.asarray(render_radiance(
        sc.device(), cam, rngu.base_key(), 4, 6, width=W, height=H,
        camera_model="look_at")) / 4
    np.testing.assert_allclose(
        thin, np.broadcast_to(bg, thin.shape), atol=1e-5)

    sc2 = Scene(capacity=4, background_start=tuple(bg),
                background_end=tuple(bg))
    sc2.add_medium_sphere((0, 0, -2), 1.2, density=200.0,
                          albedo=(0.2, 0.2, 0.2))
    dense = np.asarray(render_radiance(
        sc2.device(), cam, rngu.base_key(), 8, 12, width=W, height=H,
        camera_model="look_at")) / 8
    # center pixels look straight into the dense ball: transmission is
    # ~zero, so only near-surface BACKSCATTER remains — bounded by one
    # albedo factor (0.2 * bg ~ 0.04-0.1) and far below the direct bg
    mid = dense[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3]
    assert mid.max() < 0.12, mid.max()
    assert mid.mean() < 0.06, mid.mean()
    # corner pixels miss it: exact background
    np.testing.assert_allclose(dense[0, 0], bg, atol=1e-5)


def test_bvh_accel_matches_brute():
    """The BVH path keeps media OUT of the tree and combines a brute
    media-only pass by closest hit — statistically identical images."""
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn

    sc, cam = _small_smoke()
    sd = sc.device()
    W, H, SPP, D = 24, 16, 16, 6
    brute = np.asarray(render_radiance(
        sd, cam, rngu.base_key(), SPP, D, width=W, height=H,
        camera_model="look_at")) / SPP
    bvh = build_bvh(sc)
    accel = np.asarray(render_radiance(
        sd, cam, rngu.base_key(3), SPP, D, width=W, height=H,
        camera_model="look_at",
        hit_fn=make_bvh_hit_fn(bvh, sd))) / SPP
    blk_b = brute.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    blk_a = accel.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    assert np.abs(blk_b - blk_a).mean() < 0.05


def first_hit_features(sc, cam, W, H, traversal):
    """G-buffer of ``sc``: through gbuffer_step (the viewer's call) for the
    brute scan and the BVH's default walk, through primary_features with
    the interpreted kernel's hit function for ``"interpret"``."""
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn
    from cudaraytracer_tpu.ops.gbuffer import gbuffer_step, primary_features

    sd = sc.device()
    if traversal == "interpret":
        return primary_features(
            sd, cam, width=W, height=H, camera_model="look_at",
            hit_fn=make_bvh_hit_fn(build_bvh(sc), sd, traversal=traversal,
                                   media=False))
    return gbuffer_step(W, H, "look_at")(
        sd, cam, None if traversal == "brute" else build_bvh(sc))


@pytest.mark.parametrize("traversal", ["brute", "xla", "interpret"])
def test_gbuffer_sees_through_media(traversal):
    """Feature buffers ignore fog on every first-hit path (brute scan, BVH
    with the XLA traversal, BVH with the closest-hit kernel): depth/normal
    come from the surfaces behind it, so the denoiser's edge stopping is
    never poisoned by a stochastic fog 'surface'."""
    from cudaraytracer_tpu.ops.gbuffer import gbuffer_step

    sc, cam = _small_smoke()
    W, H = 32, 16
    gb = first_hit_features(sc, cam, W, H, traversal)
    # ground truth: the SAME scene with the fog deleted, brute first hit —
    # the feature buffers must match (the fog boundary never registers)
    sc2, _ = _small_smoke()
    for k in sc2.active_indices():
        if int(sc2.mat_type[k]) == ISOTROPIC:
            sc2.delete(int(k))
    gb2 = gbuffer_step(W, H, "look_at")(sc2.device(), cam)
    d, d2 = np.asarray(gb.depth), np.asarray(gb2.depth)
    assert ((d > 0) != (d2 > 0)).mean() == 0.0
    np.testing.assert_allclose(d, d2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.normal), np.asarray(gb2.normal),
                               atol=1e-4)


def test_media_save_load_roundtrip(tmp_path):
    """density persists through the scene document and has_media is
    restored (the static flag drives graph selection)."""
    sc, _ = _small_smoke()
    path = str(tmp_path / "smoke.json")
    sc.save(path)
    sc2 = Scene.load(path)
    i = [int(k) for k in sc2.active_indices()
         if sc2.mat_type[k] == ISOTROPIC]
    assert len(i) == 1 and float(sc2.density[i[0]]) == 1.0
    assert sc2.device().has_media


def test_viewer_smoke_scene_e2e():
    """The registered smoke scene renders through the viewer's BVH path
    (media in the side pass) and the AOV export sees through fog."""
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application

    cfg = RenderConfig(width=32, height=16, scene="smoke", accel="auto",
                       progressive=True, max_depth=4,
                       camera_model="look_at")
    app = Application(cfg)
    rl = app.setup_default_layers()
    assert rl.cfg.accel == "bvh" and rl._sd.has_media
    app.run(max_frames=2)
    img = rl.framebuffer_rgba8()
    aov = rl.aov()
    app.close()
    assert img[..., :3].sum() > 0 and np.isfinite(img[..., :3]).all()
    assert np.isfinite(aov["depth"]).all() and (aov["depth"] > 0).any()


@pytest.mark.slow
def test_media_sharded_multichip():
    """Media through the sharded renderer with the BVH: an 8-device rows x
    samples mesh on the CPU backend renders the smoke scene finite and
    lit — the volumes feature composes with the scaling story."""
    from cudaraytracer_tpu.models.bvh import build_bvh
    from cudaraytracer_tpu.parallel import make_mesh, render_sharded

    sc, cam = _small_smoke()
    mesh = make_mesh(n_rows=4, n_samples=2)
    W, H = 32, 16
    out = render_sharded(sc.device(), cam, rngu.base_key(), 2, 4, width=W,
                         height=H, mesh=mesh, camera_model="look_at",
                         bvh=build_bvh(sc))
    img = np.asarray(out) / 2  # psum over 2 sample streams
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.02 and img.std() > 0.02
