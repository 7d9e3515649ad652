"""Importance sampling (cfg.nee, RTOW book 3 — BEYOND-REFERENCE) through
the viewer's BVH path: the estimator is a static switch of the Renderer,
so it composes with either closest-hit traversal (XLA or the kernel) and
is toggled over HTTP by a renderer rebuild."""

import json
import urllib.request

import numpy as np
import pytest

from cudaraytracer_tpu.config import RenderConfig
from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.utils import rng as rngu
from cudaraytracer_tpu.viewer.app import Application

import test_nee


def test_viewer_nee_e2e():
    """cfg.nee builds the mixture estimator into the BVH-path Renderer and
    the app renders finite, lit frames; the G-buffer (no nee) still works
    for AOV/denoise."""
    cfg = RenderConfig(width=32, height=16, scene="cornell", accel="auto",
                       progressive=True, max_depth=4, nee=True)
    app = Application(cfg)
    rl = app.setup_default_layers()
    assert rl.cfg.accel == "bvh" and rl.renderer.nee
    app.run(max_frames=2)
    img = rl.framebuffer_rgba8()
    aov = rl.aov()
    app.close()
    assert np.isfinite(img[..., :3]).all() and img[..., :3].sum() > 0
    assert np.isfinite(aov["depth"]).all()


def test_viewer_nee_toggle_e2e():
    """HTTP surface: the NEE checkbox posts {"nee": true}; the server
    rebuilds the renderer with the mixture estimator, /state reports it,
    and it toggles cleanly back off."""
    from cudaraytracer_tpu.viewer.server import ViewerServer

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.read()

    def post(port, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            method="POST")
        with urllib.request.urlopen(req) as r:
            return r.read()

    cfg = RenderConfig(width=32, height=16, spp=1, max_depth=3,
                       scene="cornell", accel="bvh", progressive=True)
    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    assert not rl.renderer.nee
    server = ViewerServer(app, port=0)
    server.start()
    port = server.port
    try:
        assert json.loads(get(port, "/state"))["options"]["nee"] is False
        post(port, "/options", {"nee": True})
        app.run(max_frames=2)
        assert json.loads(get(port, "/state"))["options"]["nee"] is True
        assert rl.renderer.nee and rl._spp_done == 2  # rebuilt, restarted
        img = rl.framebuffer_rgba8()
        assert np.isfinite(img[..., :3]).all() and img[..., :3].sum() > 0
        post(port, "/options", {"nee": False})
        app.run(max_frames=1)
        assert json.loads(get(port, "/state"))["options"]["nee"] is False
        assert not rl.renderer.nee
    finally:
        server.stop()
        app.close()


@pytest.mark.parametrize("lights", ["rect", "triangle"])
def test_nee_bvh_kernel_matches_xla_traversal(lights):
    """Same RNG stream through NEE with the closest-hit kernel
    (interpreted) and with the XLA traversal: the light-sampling rays hit
    the same primitives, so the frames agree to float noise."""
    sc = test_nee._small_light_cornell()
    if lights == "triangle":  # the same 0.4x0.4 light as two triangles
        sc.delete(5)
        h, a = 4.99, 0.2
        q = [(-a, h, -a), (a, h, -a), (a, h, a), (-a, h, a)]
        sc.add_triangle(q[0], q[1], q[2], mat_type=3, light=60.0)
        sc.add_triangle(q[0], q[2], q[3], mat_type=3, light=60.0)
    sd, bvh = sc.device(), build_bvh(sc)
    cam = scenes.cornell_like_camera()
    kw = dict(width=8, height=8, nee=True)
    key = rngu.base_key(6)
    ref = np.asarray(render_radiance(
        sd, cam, key, 2, 4, hit_fn=make_bvh_hit_fn(bvh, sd, traversal="xla"),
        **kw))
    got = np.asarray(render_radiance(
        sd, cam, key, 2, 4,
        hit_fn=make_bvh_hit_fn(bvh, sd, traversal="interpret"), **kw))
    assert np.isfinite(got).all() and got.sum() > 0
    np.testing.assert_allclose(got, ref, atol=2e-3)
