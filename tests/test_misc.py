"""Coverage for pack/tonemap, image IO, config CLI, and the CLI entry."""

import os
import subprocess
import sys

import numpy as np
import pytest

from cudaraytracer_tpu import config as cfg_mod
from cudaraytracer_tpu.ops.pack import pack_rgba8, to_rgba8, tonemap
from cudaraytracer_tpu.utils.image import load_rgb, save_png


def test_tonemap_gamma_and_pack():
    rad = np.full((2, 2, 3), 0.25, np.float32) * 4  # sum of 4 spp at 0.25
    disp = np.asarray(tonemap(rad, 4))
    np.testing.assert_allclose(disp, 0.5, atol=1e-6)  # sqrt(0.25)
    rgba = np.asarray(pack_rgba8(rad, 4))
    assert rgba.dtype == np.uint8 and rgba.shape == (2, 2, 4)
    assert abs(int(rgba[0, 0, 0]) - 127) <= 1
    assert (rgba[..., 3] == 255).all()
    # clipping
    hot = np.full((1, 1, 3), 9.0, np.float32)
    assert (np.asarray(to_rgba8(np.asarray(tonemap(hot, 1))))[..., :3] == 255).all()


def test_save_load_png_roundtrip(tmp_path):
    img = (np.random.RandomState(0).rand(8, 6, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    save_png(p, img, flip_vertical=False)
    back = load_rgb(p)
    np.testing.assert_array_equal(back, img)
    save_png(p, img, flip_vertical=True)
    np.testing.assert_array_equal(load_rgb(p), img[::-1])


def test_config_cli_roundtrip():
    import argparse

    ap = argparse.ArgumentParser()
    cfg_mod.add_arguments(ap)
    args = ap.parse_args([
        "--width", "64", "--height", "48", "--spp", "5", "--max-depth", "7",
        "--scene", "cornell", "--accel", "bvh", "--aperture", "0.2",
        "--no-progressive",
    ])
    cfg = cfg_mod.from_args(args)
    assert (cfg.width, cfg.height, cfg.spp, cfg.max_depth) == (64, 48, 5, 7)
    assert cfg.scene == "cornell" and cfg.accel == "bvh"
    assert cfg.aperture == 0.2 and not cfg.progressive


def test_config_camera_model_from_scene_registry():
    """--camera-model defaults to the model each scene's registered camera
    was authored for; an explicit flag wins over the registry."""
    import argparse

    from cudaraytracer_tpu.models import scenes

    def parse(argv):
        ap = argparse.ArgumentParser()
        cfg_mod.add_arguments(ap)
        return cfg_mod.from_args(ap.parse_args(argv))

    assert parse([]).camera_model == "two_plane"  # default scene
    for name in scenes.SCENES:
        assert parse(["--scene", name]).camera_model == \
            scenes.camera_model_for(name)
    assert parse(["--scene", "mesh_demo"]).camera_model == "look_at"
    assert parse(["--scene", "mesh_demo",
                  "--camera-model", "two_plane"]).camera_model == "two_plane"


@pytest.mark.slow
def test_cli_render_subprocess(tmp_path):
    """End-to-end: the module CLI renders a PNG headlessly."""
    out = str(tmp_path / "cli.png")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "cudaraytracer_tpu", "render", "--cpu",
         "--width", "48", "--height", "32", "--spp", "2", "--max-depth", "3",
         "--frames", "2", "-o", out],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    img = load_rgb(out)
    assert img.shape == (32, 48, 3)
    assert img.sum() > 0


def _write_ball_obj(path):
    from cudaraytracer_tpu.utils import mesh

    v, f = mesh.icosphere(1)  # 80 faces
    v = v * 3.0 + (5.0, 2.0, -1.0)  # offset/scale: normalization must undo
    mesh.save_obj(str(path), v, f, normals=(v - (5.0, 2.0, -1.0)) / 3.0)
    return len(f)


def test_register_obj_scene(tmp_path):
    """--obj scene registration: normalization, attrs, registry entries."""
    from cudaraytracer_tpu.models import scenes as scn
    from cudaraytracer_tpu.models.bvh import primitive_aabbs
    from cudaraytracer_tpu.models.renderer import render_radiance
    from cudaraytracer_tpu.models.scene import METAL
    from cudaraytracer_tpu.utils import rng as rngu

    p = tmp_path / "ball.obj"
    nf = _write_ball_obj(p)
    name = scn.register_obj_scene(str(p), mat_type=METAL, fuzz=0.1)
    try:
        assert name == "obj:ball"
        assert name in scn.SCENES
        assert scn.camera_model_for(name) == "look_at"
        make_scene, make_cam = scn.SCENES[name]
        scene = make_scene()
        idx = scene.active_indices()
        assert len(idx) == nf + 1  # ground rect + triangles
        assert scene.has_vertex_attrs  # file normals kept (smooth shading)
        # normalized: 2-unit max extent resting on the y=-0.5 ground
        bmin, bmax = primitive_aabbs(scene, idx)
        tri = scene.prim_type[idx] == 4
        lo, hi = bmin[tri].min(0), bmax[tri].max(0)
        assert abs(float((hi - lo).max()) - 2.0) < 1e-3
        assert abs(float(lo[1]) + 0.5) < 1e-3
        img = np.asarray(render_radiance(
            scene.device(), make_cam(), rngu.base_key(), 1, 2,
            width=24, height=16, camera_model="look_at"))
        assert np.isfinite(img).all() and img.sum() > 0
    finally:
        scn.SCENES.pop(name, None)
        scn.CAMERA_MODELS.pop(name, None)


@pytest.mark.slow
def test_cli_render_obj_subprocess(tmp_path):
    """End-to-end: `render --obj model.obj` renders the model headlessly."""
    p = tmp_path / "ball.obj"
    _write_ball_obj(p)
    out = str(tmp_path / "obj.png")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "cudaraytracer_tpu", "render", "--cpu",
         "--obj", str(p), "--obj-mat", "metal", "--obj-fuzz", "0.05",
         "--width", "48", "--height", "32", "--spp", "2", "--max-depth", "3",
         "--frames", "2", "-o", out],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    img = load_rgb(out)
    assert img.shape == (32, 48, 3)
    assert img.sum() > 0


def test_terrain_texture_height_alignment():
    """The terrain texture is height-painted: the texel each vertex's uv
    actually SAMPLES (ops/textures.py mapping: col = u*w, row = (1-v)*h)
    must match the palette color of that vertex's height.  Guards the
    image orientation (a transposed/flipped paint passed rendering tests
    while coloring random geometry)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from cudaraytracer_tpu.models import scenes as scn

    sc = scn.terrain_scene()
    idx = sc.active_indices()
    tid = int(sc.tex_id[idx[0]])
    h, w = sc.tex_hw[tid]
    img = sc.atlas[tid, :h, :w].astype(float) / 255.0
    tri = idx[sc.prim_type[idx] == 4]
    uv = sc.uv0[tri]
    t = sc.center[tri][:, 1]
    t = (t - t.min()) / (t.max() - t.min())
    lo = np.array([0.18, 0.42, 0.12])
    mid = np.array([0.45, 0.40, 0.33])
    hi = np.array([0.92, 0.94, 0.97])
    w_lo = np.clip(1.0 - t / 0.72, 0, 1)
    w_hi = np.clip((t - 0.78) / 0.22, 0, 1)
    w_mid = np.clip(1.0 - w_lo - w_hi, 0, 1)
    want = w_lo[:, None] * lo + w_mid[:, None] * mid + w_hi[:, None] * hi
    i = np.minimum((np.clip(uv[:, 0], 0, 1) * w).astype(int), w - 1)
    j = np.minimum(((1.0 - np.clip(uv[:, 1], 0, 1)) * h).astype(int), h - 1)
    err = np.abs(img[j, i] - want)
    assert err.max() < 0.08, err.max()


@pytest.mark.slow
def test_every_registered_scene_renders():
    """Registry smoke test: every SCENES entry constructs and renders a
    tiny brute-force frame with finite, non-black output (guards new
    scenes — rtow_image, rtow_big — against bit-rot in any path)."""
    import numpy as np

    from cudaraytracer_tpu.models import scenes as scn
    from cudaraytracer_tpu.models.renderer import render_radiance
    from cudaraytracer_tpu.utils import rng as rngu

    for name, (make_scene, make_cam) in scn.SCENES.items():
        scene = make_scene()
        cam = make_cam()
        model = scn.camera_model_for(name)  # the authored projection
        img = np.asarray(render_radiance(
            scene.device(), cam, rngu.base_key(), 1, 2,
            width=24, height=16, camera_model=model))
        assert np.isfinite(img).all(), name
        assert img.sum() > 0, name


@pytest.mark.slow
def test_pfm_roundtrip_and_cli_hdr(tmp_path):
    """PFM write/read round-trips floats exactly, and `render -o out.pfm`
    exports linear HDR radiance whose gamma-2 tonemap matches the PNG."""
    from cudaraytracer_tpu.utils.image import load_pfm, save_pfm

    rad = np.random.RandomState(3).rand(6, 8, 3).astype(np.float32) * 4.0
    p = str(tmp_path / "x.pfm")
    save_pfm(p, rad)
    np.testing.assert_array_equal(load_pfm(p), rad)

    outp = str(tmp_path / "r.pfm")
    outpng = str(tmp_path / "r.png")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "cudaraytracer_tpu", "render", "--cpu",
            "--width", "48", "--height", "32", "--spp", "2",
            "--max-depth", "3", "--frames", "2", "--seed", "5"]
    for out in (outp, outpng):
        r = subprocess.run(base + ["-o", out], capture_output=True,
                           text=True, timeout=300, env=env)
        assert r.returncode == 0, r.stderr[-2000:]
    hdr = load_pfm(outp)
    assert hdr.shape == (32, 48, 3) and np.isfinite(hdr).all()
    png = load_rgb(outpng).astype(np.float32) / 255.0
    # same frames (same seed): png == gamma-2(clamped hdr) within quantization
    want = np.sqrt(np.clip(hdr, 0.0, 1.0))
    assert np.abs(want - png).max() < 1.5 / 255.0 + 1e-4

