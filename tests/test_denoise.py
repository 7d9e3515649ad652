"""G-buffer + display-time denoiser tests (ops/gbuffer.py, ops/denoise.py).

Beyond-reference subsystem (the CUDA reference has no denoiser or AOVs —
its only noise control is brute spp, Kernel.cu:137-148).  Coverage:
G-buffer semantics against the production intersection stack, the
edge-avoiding a-trous filter's two load-bearing properties (noise goes
DOWN inside regions, edges do NOT bleed), the jitted display step, the
SVGF variance path, and the RenderLayer / viewer integration.
"""

import json
import urllib.request

import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.ops.denoise import atrous_denoise, denoise_step
from cudaraytracer_tpu.ops.gbuffer import GBuffer, gbuffer_step, primary_features


# ----------------------------------------------------------------- gbuffer
def test_gbuffer_semantics_default_scene():
    W, H = 32, 24
    scene = scenes.default_scene()
    sd = scene.device()
    cam = scenes.default_scene_camera()
    gb = primary_features(sd, cam, width=W, height=H)
    n = np.asarray(gb.normal)
    a = np.asarray(gb.albedo)
    z = np.asarray(gb.depth)
    assert n.shape == (H, W, 3) and a.shape == (H, W, 3) and z.shape == (H, W)
    hit = z > 0
    assert 0.2 < hit.mean() < 0.95  # scene covers part of the frame
    # hit normals are unit and front-facing would require the ray dirs;
    # unit-ness alone pins the normalization convention
    norms = np.linalg.norm(n[hit], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)
    # miss pixels: zero normal, zero depth, sky-gradient albedo (white ->
    # blue-ish: channel ordering b >= g >= r for the default background)
    assert np.all(n[~hit] == 0.0)
    sky = a[~hit]
    assert sky.size and np.all(sky[:, 2] >= sky[:, 0] - 1e-6)
    assert np.isfinite(a).all() and a.min() >= 0.0


@pytest.mark.slow
def test_gbuffer_jit_step_matches_eager():
    W, H = 24, 16
    scene = scenes.default_scene()
    sd = scene.device()
    cam = scenes.default_scene_camera()
    eager = primary_features(sd, cam, width=W, height=H)
    jitted = gbuffer_step(W, H, "two_plane")(sd, cam)
    # jit fuses/reassociates the normalization math: ~1e-3 f32 drift
    for e, j in zip(eager, jitted):
        np.testing.assert_allclose(np.asarray(e), np.asarray(j), atol=2e-3)


def test_gbuffer_mesh_smooth_normals():
    """Vertex-attr scenes feed SHADING normals into the G-buffer: across a
    smooth-shaded sphere mesh the normals vary inside each face (flat
    shading would make them piecewise constant)."""
    W, H = 48, 32
    make_scene, make_cam = scenes.SCENES["mesh_smooth"]
    sd = make_scene().device()
    cam = make_cam()
    gb = primary_features(sd, cam, width=W, height=H,
                          camera_model=scenes.camera_model_for("mesh_smooth"))
    z = np.asarray(gb.depth)
    n = np.asarray(gb.normal)
    hit = z > 0
    assert hit.sum() > 50
    norms = np.linalg.norm(n[hit], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


# ----------------------------------------------------------------- filter
def _two_region_gbuffer(h, w):
    """Left half: near flat wall (n=+z, depth 1, dark albedo).  Right
    half: far wall (n=+x, depth 5, bright albedo)."""
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2:, 0] = 1.0
    albedo = np.full((h, w, 3), 0.2, np.float32)
    albedo[:, w // 2:] = 0.8
    depth = np.full((h, w), 1.0, np.float32)
    depth[:, w // 2:] = 5.0
    return GBuffer(normal=normal, albedo=albedo, depth=depth)


def test_denoise_reduces_noise_without_edge_bleed():
    h, w = 32, 64
    gb = _two_region_gbuffer(h, w)
    rng = np.random.default_rng(3)
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = 0.25
    clean[:, w // 2:] = 0.75
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = np.asarray(atrous_denoise(noisy, gb, iterations=3))
    # noise drops by >= 2x inside each region
    for sl in (np.s_[:, : w // 2 - 4], np.s_[:, w // 2 + 4:]):
        before = np.abs(noisy[sl] - clean[sl]).mean()
        after = np.abs(out[sl] - clean[sl]).mean()
        assert after < before / 2, (before, after)
    # the edge does not bleed: the first column past the boundary stays
    # within noise of ITS region's value, nowhere near the other side
    left_edge = out[:, w // 2 - 1].mean()
    right_edge = out[:, w // 2].mean()
    assert abs(left_edge - 0.25) < 0.08
    assert abs(right_edge - 0.75) < 0.08


@pytest.mark.slow
def test_denoise_constant_image_is_fixed_point():
    h, w = 16, 32
    gb = _two_region_gbuffer(h, w)
    const = np.full((h, w, 3), 0.4, np.float32)
    out = np.asarray(atrous_denoise(const, gb, iterations=4))
    np.testing.assert_allclose(out, const, atol=1e-4)


@pytest.mark.slow
def test_denoise_jit_step_and_variance_path():
    h, w = 24, 32
    gb = _two_region_gbuffer(h, w)
    rng = np.random.default_rng(0)
    noisy = np.clip(
        np.asarray(gb.albedo) + rng.normal(0, 0.1, (h, w, 3)), 0, 1
    ).astype(np.float32)
    eager = np.asarray(atrous_denoise(noisy, gb, iterations=2))
    jitted = np.asarray(
        denoise_step(h, w, 2)(noisy, gb.normal, gb.albedo, gb.depth))
    np.testing.assert_allclose(eager, jitted, atol=1e-5)
    # variance plane: noisier pixels accept more smoothing; output finite
    var = np.full((h, w), 0.01, np.float32)
    outv = np.asarray(
        denoise_step(h, w, 2)(noisy, gb.normal, gb.albedo, gb.depth, var))
    assert np.isfinite(outv).all()
    # the sky convention: zero-normal pixels smooth with each other
    gb_sky = GBuffer(
        normal=np.zeros((h, w, 3), np.float32),
        albedo=np.asarray(gb.albedo),
        depth=np.zeros((h, w), np.float32),
    )
    out_sky = np.asarray(atrous_denoise(noisy, gb_sky, iterations=2))
    assert np.isfinite(out_sky).all()
    # smoothing actually happened on the uniform-feature field
    assert out_sky.std() < noisy.std()


# ------------------------------------------------------------ integration


@pytest.mark.slow
def test_render_layer_denoised_display():
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application

    cfg = RenderConfig(width=32, height=24, max_depth=3, scene="default",
                       accel="bvh", denoise=True, denoise_iters=2,
                       progressive=True)
    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    img_dn = rl.framebuffer_rgba8()
    assert img_dn.shape == (24, 32, 4) and img_dn.dtype == np.uint8
    hdr = rl.radiance_mean()
    assert np.isfinite(hdr).all()
    # toggling OFF routes back to the raw path instantly (display-only)
    rl.cfg.denoise = False
    img_raw = rl.framebuffer_rgba8()
    assert img_raw.shape == img_dn.shape
    # at 2 spp the raw frame is noisy; the denoised one is smoother
    # (total variation strictly lower)
    def tv(img):
        f = img[..., :3].astype(np.float32)
        return (np.abs(np.diff(f, axis=0)).mean()
                + np.abs(np.diff(f, axis=1)).mean())

    assert tv(img_dn) < tv(img_raw)
    # the G-buffer is cached per (scene, camera) version
    key0 = rl._gb_key
    rl.cfg.denoise = True
    rl.framebuffer_rgba8()
    assert rl._gb_key == key0
    app.close()


@pytest.mark.slow
def test_render_layer_aov_export(tmp_path):
    from cudaraytracer_tpu.__main__ import _write_aov
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application

    cfg = RenderConfig(width=40, height=30, max_depth=3, scene="default",
                       accel="bvh")
    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    aov = rl.aov()
    assert set(aov) == {"normal", "albedo", "depth"}
    assert aov["normal"].shape == (30, 40, 3)
    assert aov["depth"].shape == (30, 40)
    # display orientation: the default scene's ground occupies the image
    # BOTTOM, so hits concentrate in the lower half after the flip
    hit = aov["depth"] > 0
    assert hit[15:].mean() > hit[:15].mean()
    # .npz round trip
    p = tmp_path / "aov.npz"
    _write_aov(rl, str(p))
    z = np.load(p)
    np.testing.assert_array_equal(z["depth"], aov["depth"])
    # PNG visualization prefix form
    _write_aov(rl, str(tmp_path / "vis"))
    for name in ("normal", "albedo", "depth"):
        assert (tmp_path / f"vis_{name}.png").exists()
    app.close()


@pytest.mark.slow
def test_viewer_denoise_toggle_e2e():
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application
    from cudaraytracer_tpu.viewer.server import ViewerServer

    app = Application(RenderConfig(width=32, height=24, max_depth=3,
                                   scene="default", accel="bvh"))
    app.setup_default_layers()
    app.run(max_frames=1)
    server = ViewerServer(app, port=0)
    httpd = server.start()
    port = httpd.server_address[1]
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}") as r:
                return r.read()

        def post(path, body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req) as r:
                return r.read()

        assert json.loads(get("/state"))["options"]["denoise"] is False
        post("/options", {"denoise": True})
        assert json.loads(get("/state"))["options"]["denoise"] is True
        png = get("/frame.png")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"dns" in get("/")  # the checkbox is in the page
        post("/options", {"denoise": False})
        assert json.loads(get("/state"))["options"]["denoise"] is False
    finally:
        server.stop()
        app.close()
