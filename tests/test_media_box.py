"""BOX-bounded constant-density media (Cornell smoke) — BEYOND-REFERENCE.

The RTOW book-2 ``cornell_smoke`` analog (the CUDA reference has neither
boxes nor volumes, Hittable.cuh:30-38): ``Scene.add_medium_box`` adds a
prim-type BOX whose material is ALWAYS ISOTROPIC — an invisible
axis-aligned boundary whose interior scatters isotropically at a
distance sampled from exp(-density * s).  Wired through every path that
carries sphere media: the XLA brute scan (ops/intersect.py
_medium_box_block_t), the BVH accel (media live OUTSIDE the tree, with
either traversal), the G-buffer (which sees through them), the oracle, the
scene registry ("cornell_smoke") and save/load.
"""

import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.camera import make_camera_params
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.models.scene import (BOX, DIFFUSE_LIGHT, ISOTROPIC,
                                            LAMBERTIAN, METAL, Scene)
from cudaraytracer_tpu.utils import rng as rngu

import oracle


def _small_box_smoke():
    """The test_media smoke scene with the fog SPHERE swapped for a fog
    BOX (and a glow background so structure checks are not vacuous)."""
    sc = Scene(capacity=16, background_start=(0.05, 0.05, 0.07),
               background_end=(0.05, 0.05, 0.07))
    sc.add_xz_rect((0, -1, 0), 40, 40, mat_type=LAMBERTIAN,
                   albedo=(0.6, 0.6, 0.6))
    sc.add_sphere((0, 5, -3), 1.6, mat_type=DIFFUSE_LIGHT, light=5.0)
    sc.add_medium_box((0, 1.2, -3), (3.2, 2.6, 3.2), density=1.0,
                      albedo=(0.85, 0.85, 0.9))
    sc.add_sphere((0, 1.0, -3), 0.6, mat_type=METAL,
                  albedo=(0.9, 0.7, 0.4), fuzz=0.05)
    cam = make_camera_params(origin=(0.0, 1.8, 5.0),
                             forward=(0.0, -0.05, -1.0), fov_deg=55.0)
    return sc, cam


@pytest.mark.slow
def test_box_smoke_matches_oracle():
    """Box-fog scattering + an embedded metal sphere vs the scalar
    oracle's slab-chord ConstantMedium (block means)."""
    sc, cam = _small_box_smoke()
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


def test_box_medium_limits():
    """Physical limits pin the slab-chord sampling: a near-zero-density
    box is EXACTLY transparent, and an extremely dense one blocks like a
    box-shaped shell — its square silhouette darkens the frame center
    while corner rays that miss it see exact background."""
    W, H = 32, 24
    cam = make_camera_params(origin=(0, 0, 3), forward=(0, 0, -1),
                             fov_deg=60.0)
    bg = np.array([0.2, 0.3, 0.5], np.float32)
    sc = Scene(capacity=4, background_start=tuple(bg),
               background_end=tuple(bg))
    sc.add_medium_box((0, 0, -2), (2.0, 2.0, 2.0), density=1e-6,
                      albedo=(1, 0, 0))
    thin = np.asarray(render_radiance(
        sc.device(), cam, rngu.base_key(), 4, 6, width=W, height=H,
        camera_model="look_at")) / 4
    np.testing.assert_allclose(
        thin, np.broadcast_to(bg, thin.shape), atol=1e-5)

    sc2 = Scene(capacity=4, background_start=tuple(bg),
                background_end=tuple(bg))
    sc2.add_medium_box((0, 0, -2), (2.0, 2.0, 2.0), density=200.0,
                       albedo=(0.2, 0.2, 0.2))
    dense = np.asarray(render_radiance(
        sc2.device(), cam, rngu.base_key(), 8, 12, width=W, height=H,
        camera_model="look_at")) / 8
    mid = dense[H // 2 - 3:H // 2 + 3, W // 2 - 3:W // 2 + 3]
    assert mid.max() < 0.12, mid.max()
    assert mid.mean() < 0.06, mid.mean()
    # corner pixels miss the box: exact background
    np.testing.assert_allclose(dense[0, 0], bg, atol=1e-5)


def test_box_medium_chord_is_exact():
    """Deterministic chord geometry: a ray entering the box face-on must
    never scatter before the slab entry or after the exit — with density
    d and interior chord L, the analytic transmission exp(-d*L) is
    reproduced by the sampled hit-rate to MC accuracy."""
    rng = np.random.RandomState(5)
    o = np.array([0.0, 0.0, 3.0])
    d = np.array([0.0, 0.0, -1.0])
    c = np.array([0.0, 0.0, -1.0])
    he = np.array([1.0, 1.0, 1.5])  # slab z in [-2.5, 0.5]: entry t=2.5,
    density, L = 0.7, 3.0           # exit t=5.5, chord L=3.0
    hits = 0
    n = 4000
    for _ in range(n):
        t = oracle._medium_box_hit(o, d, c, he, density, rng, 1e-3, 1e9)
        if t is not None:
            # scatter point strictly inside the slab chord
            assert 2.5 - 1e-6 <= t <= 5.5 + 1e-6
            hits += 1
    p_hit = hits / n
    assert abs(p_hit - (1.0 - np.exp(-density * L))) < 0.03


def test_bvh_accel_matches_brute_box():
    """The BVH path keeps BOX media OUT of the tree (mat ISOTROPIC side)
    and bounds them with half-extent AABBs — statistically identical
    images to the brute scan."""
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn

    sc, cam = _small_box_smoke()
    sd = sc.device()
    assert sd.has_media and sd.has_box_media
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


@pytest.mark.parametrize("yaw", [0.0, 0.6])
@pytest.mark.parametrize("traversal", ["brute", "xla", "interpret"])
def test_gbuffer_sees_through_box_media(traversal, yaw):
    """Feature buffers ignore box fog (axis-aligned and yaw-rotated) on
    every first-hit path — brute scan, BVH with the XLA traversal, BVH
    with the closest-hit kernel: depth/normal come from the surfaces
    behind it."""
    from cudaraytracer_tpu.ops.gbuffer import gbuffer_step
    from test_media import first_hit_features

    sc, cam = _rotated_box_smoke(yaw) if yaw else _small_box_smoke()
    W, H = 32, 16
    gb = first_hit_features(sc, cam, W, H, traversal)
    sc2, _ = _small_box_smoke()
    for k in sc2.active_indices():
        if int(sc2.mat_type[k]) == ISOTROPIC:
            sc2.delete(int(k))
    gb2 = gbuffer_step(W, H, "look_at")(sc2.device(), cam)
    d, d2 = np.asarray(gb.depth), np.asarray(gb2.depth)
    assert ((d > 0) != (d2 > 0)).mean() == 0.0
    np.testing.assert_allclose(d, d2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.normal), np.asarray(gb2.normal),
                               atol=1e-4)


def _rotated_box_smoke(yaw=0.6):
    """_small_box_smoke with the fog box YAW-ROTATED (round 5: the RTOW
    rotate_y instance transform for medium boxes)."""
    sc, cam = _small_box_smoke()
    for k in sc.active_indices():
        if int(sc.prim_type[k]) == BOX:
            sc.update(int(k), yaw=yaw)
    return sc, cam


def test_rotated_box_chord_is_exact():
    """Deterministic rotated-chord geometry: a 45-degree box of
    half-extents (1, 1, 1) centered at the origin, probed along -z
    through its center, has object-space slab entry/exit at t = z0 -/+
    sqrt(2) (the rotated square's diagonal half-width) — every oracle
    scatter lands strictly inside that chord, and the hit rate matches
    the analytic transmission of the sqrt(8) chord."""
    rng = np.random.RandomState(5)
    o = np.array([0.0, 0.0, 3.0])
    d = np.array([0.0, 0.0, -1.0])
    c = np.array([0.0, 0.0, 0.0])
    he = np.array([1.0, 1.0, 1.0])
    yaw = np.pi / 4
    lo, hi = 3.0 - np.sqrt(2.0), 3.0 + np.sqrt(2.0)
    density, L = 0.5, 2.0 * np.sqrt(2.0)
    hits = 0
    n = 4000
    for _ in range(n):
        t = oracle._medium_box_hit(o, d, c, he, density, rng, 1e-3, 1e9,
                                   yaw=yaw)
        if t is not None:
            assert lo - 1e-6 <= t <= hi + 1e-6
            hits += 1
    assert abs(hits / n - (1.0 - np.exp(-density * L))) < 0.03


def test_rotated_box_rotation_is_applied():
    """Rotation about Y WIDENS the x-z footprint: seen along -z, a ray
    at x ~ 1.19 misses the axis-aligned unit-half-extent box (edge at
    x = 1) but crosses the 45-degree diamond (silhouette out to
    sqrt(2)) — so that pixel flips from exact background to opaque when
    yaw is applied, and the frame center stays blocked either way."""
    W, H = 33, 33
    cam = make_camera_params(origin=(0, 0, 6), forward=(0, 0, -1),
                             fov_deg=40.0)
    bg = np.array([0.2, 0.3, 0.5], np.float32)

    def render(yaw):
        sc = Scene(capacity=4, background_start=tuple(bg),
                   background_end=tuple(bg))
        sc.add_medium_box((0, 0, 0), (2.0, 2.0, 2.0), density=400.0,
                          yaw=yaw, albedo=(0.0, 0.0, 0.0))
        assert sc.device().has_rot_media == (yaw != 0.0)
        return np.asarray(render_radiance(
            sc.device(), cam, rngu.base_key(), 8, 8, width=W, height=H,
            camera_model="look_at")) / 8

    aligned = render(0.0)
    rotated = render(float(np.pi / 4))
    # both block the center ray
    assert aligned[H // 2, W // 2].max() < 0.05
    assert rotated[H // 2, W // 2].max() < 0.05
    # the measured blocked half-width of the middle row grows by the
    # diamond's sqrt(2) (perspective shifts it slightly; bracket wide)
    def half_width(img):
        blocked = img[H // 2].max(-1) < 0.1
        assert blocked[W // 2]
        return max(abs(i - W // 2) for i in range(W) if blocked[i])

    wa, wr = half_width(aligned), half_width(rotated)
    ratio = wr / wa
    assert 1.2 < ratio < 1.65, (wa, wr)
    # containment on the center row: every pixel the aligned box blocks
    # the diamond blocks too, and the diamond blocks strictly more
    ba = aligned[H // 2].max(-1) < 0.1
    br = rotated[H // 2].max(-1) < 0.1
    assert not (ba & ~br).any()
    assert int((br & ~ba).sum()) >= 4, (wa, wr)


@pytest.mark.slow
def test_rotated_box_matches_oracle():
    """The rotated fog box vs the scalar oracle's rotated slab chord
    (block means) — brute XLA path."""
    sc, cam = _rotated_box_smoke()
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


def test_rotated_bvh_accel_matches_brute():
    """The BVH side-scan carries yaw, and the swept (|c|/|s|) AABB keeps
    the rotated box inside its cluster/tree bounds — statistically
    identical images to the brute scan."""
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn

    sc, cam = _rotated_box_smoke()
    sd = sc.device()
    assert sd.has_rot_media
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


def test_rotated_box_save_load_and_update(tmp_path):
    """yaw persists through the scene document (has_rot_media restored),
    Scene.update(i, yaw=...) edits it, and non-box prims reject it."""
    sc, _ = _rotated_box_smoke(yaw=0.35)
    path = str(tmp_path / "rot_smoke.json")
    sc.save(path)
    sc2 = Scene.load(path)
    i = [int(k) for k in sc2.active_indices() if sc2.prim_type[k] == BOX]
    assert len(i) == 1
    assert abs(float(sc2.edge2[i[0], 0]) - 0.35) < 1e-7
    assert sc2.device().has_rot_media
    sc2.update(i[0], yaw=0.0)
    assert not sc2.device().has_rot_media
    with pytest.raises(ValueError):
        sc2.update(0, yaw=0.1)  # slot 0 is the ground rect


def test_box_media_save_load_roundtrip(tmp_path):
    """half_ext + density persist through the scene document and the
    has_box_media static flag is restored (it drives graph selection)."""
    sc, _ = _small_box_smoke()
    path = str(tmp_path / "box_smoke.json")
    sc.save(path)
    sc2 = Scene.load(path)
    i = [int(k) for k in sc2.active_indices()
         if sc2.prim_type[k] == BOX]
    assert len(i) == 1
    np.testing.assert_allclose(sc2.edge1[i[0]], (1.6, 1.3, 1.6))
    assert float(sc2.density[i[0]]) == 1.0
    sd = sc2.device()
    assert sd.has_media and sd.has_box_media


def test_cornell_smoke_scene_registered_e2e():
    """The registered cornell_smoke scene builds (room + light + two
    yaw-rotated medium boxes) and renders finite through the viewer's BVH
    path, boxes in the side pass."""
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application

    sc = scenes.cornell_smoke_scene()
    prim_t = sc.prim_type[sc.active_indices()]
    assert (prim_t == BOX).sum() == 2
    sd = sc.device()
    assert sd.has_box_media and sd.has_rot_media  # the book's rotations

    cfg = RenderConfig(width=32, height=16, scene="cornell_smoke",
                       accel="auto", progressive=True, max_depth=4)
    app = Application(cfg)
    rl = app.setup_default_layers()
    assert rl.cfg.accel == "bvh" and rl._sd.has_rot_media
    app.run(max_frames=2)
    img = rl.framebuffer_rgba8()
    app.close()
    assert np.isfinite(img[..., :3]).all() and img[..., :3].sum() > 0


def test_cornell_smoke_matches_oracle_statistically():
    """The registered scene end-to-end vs the oracle (low-res block
    means): the XLA brute path, the slab-chord medium sampler and the
    black-background emissive transport all agree."""
    sc = scenes.cornell_smoke_scene()
    cam = scenes.cornell_smoke_camera()
    W, H, SPP, D = 24, 16, 32, 8
    gold = oracle.render(sc, (0.0, 2.5, 9.0), (0.0, 0.0, -1.0),
                         W, H, SPP, D, seed=7, fov_deg=40.0)
    ours = np.asarray(
        render_radiance(sc.device(), cam, rngu.base_key(), SPP, D,
                        width=W, height=H, camera_model="two_plane")
    ) / SPP
    np.testing.assert_allclose(ours.mean((0, 1)), gold.mean((0, 1)),
                               atol=0.05)
    blk_g = gold.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    blk_o = ours.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    assert np.abs(blk_g - blk_o).mean() < 0.06
