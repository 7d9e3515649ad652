"""Application / layer / progressive-loop tests (Application.cpp:44-62,
LayerStack.cpp:14-40 semantics)."""

import numpy as np
import pytest

from cudaraytracer_tpu.config import RenderConfig
from cudaraytracer_tpu.viewer.app import Application, Layer, LayerStack


def small_cfg(**kw):
    d = dict(width=32, height=24, spp=2, max_depth=3, scene="default",
             accel="brute", progressive=True)
    d.update(kw)
    return RenderConfig(**d)


def test_layer_stack_order():
    order = []

    class L(Layer):
        def __init__(self, tag):
            super().__init__(tag)
            self.tag = tag

        def on_update(self):
            order.append(self.tag)

    st = LayerStack()
    st.push_overlay(L("overlay"))
    st.push_layer(L("layer1"))
    st.push_layer(L("layer2"))
    for layer in st:
        layer.on_update()
    # layers run before overlays (LayerStack.cpp:14-27)
    assert order == ["layer1", "layer2", "overlay"]


def test_progressive_accumulation_and_reset():
    app = Application(small_cfg())
    rl = app.setup_default_layers()
    app.run(max_frames=3)
    assert rl._spp_done == 3
    img1 = rl.framebuffer_rgba8()
    assert img1.shape == (24, 32, 4) and img1.dtype == np.uint8
    # camera edit resets accumulation (reference re-renders per edit)
    rl.fly.process_keys(["w"])
    app.run(max_frames=1)
    assert rl._spp_done == 1
    # scene edit also resets
    rl.scene.add_sphere((0, 1, 0), 0.4)
    app.run(max_frames=2)
    assert rl._spp_done == 2
    app.close()


def test_pause_skips_updates():
    """The run loop must actually idle while paused (the P-key semantics,
    Window.h:24): frames stop advancing, and resume continues them."""
    import threading
    import time

    app = Application(small_cfg())
    rl = app.setup_default_layers()
    app.run(max_frames=1)  # compile + one frame
    app.paused = True
    t = threading.Thread(target=app.run, daemon=True)  # live loop, no cap
    t.start()
    time.sleep(0.6)
    assert rl._frame_index == 1  # the loop ran but rendered nothing
    app.toggle_pause()
    deadline = time.time() + 30
    while rl._frame_index == 1 and time.time() < deadline:
        time.sleep(0.05)
    assert rl._frame_index > 1  # resume renders again
    app.running = False
    t.join(timeout=10)
    assert not t.is_alive()
    app.close()


def test_non_progressive_full_spp():
    app = Application(small_cfg(progressive=False, spp=3))
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    assert rl._spp_done == 3
    assert rl.metrics.rays_last_frame > 32 * 24  # bounces counted
    app.close()


def test_bvh_accel_app():
    app = Application(small_cfg(accel="bvh"))
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    assert rl._bvh is not None
    img = rl.framebuffer_rgba8()
    assert img[..., :3].sum() > 0
    app.close()


def test_bvh_kernel_app_interpret(interpret_kernel, monkeypatch):
    """The viewer's BVH path with the closest-hit kernel (interpreted)
    renders the same frames as with the XLA traversal."""
    app = Application(small_cfg(accel="bvh", width=16, height=8))
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    assert interpret_kernel and set(interpret_kernel) == {"interpret"}
    img = rl.framebuffer_rgba8()
    assert img.shape == (8, 16, 4) and img[..., :3].sum() > 0
    monkeypatch.undo()
    ref = Application(small_cfg(accel="bvh", width=16, height=8))
    rl_ref = ref.setup_default_layers()
    ref.run(max_frames=2)
    assert np.abs(img.astype(int) - rl_ref.framebuffer_rgba8()).max() <= 1
    app.close()
    ref.close()


def test_fly_camera_starts_at_registered_pose():
    """Every registered scene's viewer session must open at that scene's
    registered camera (previously only rtow* scenes got a pose and
    mirror_room opened BEHIND its area light)."""
    import math

    from cudaraytracer_tpu.models import scenes as scn
    from cudaraytracer_tpu.viewer.app import RenderLayer

    for name in ("cornell", "mirror_room", "rtow_final"):
        cfg = small_cfg(scene=name, camera_model="look_at")
        rl = RenderLayer(cfg)
        cam0 = scn.SCENES[name][1]()
        assert np.allclose(rl.fly.position, np.asarray(cam0.origin), atol=1e-5)
        assert abs(rl.fly.fov_deg - math.degrees(float(cam0.fov))) < 1e-3
        # orientation reproduces the registered forward vector
        f = np.asarray(cam0.forward, np.float64)
        f = f / np.linalg.norm(f)
        assert np.allclose(rl.fly.orientation, f, atol=1e-5)


def test_scene_edits_do_not_recompile():
    """Scene edits rebuild the BVH on the host; the scene arrays and the
    tree are jit ARGUMENTS, so the jitted frame is reused, not re-traced
    (the reference's drag-edit -> rebuild hot path)."""
    app = Application(small_cfg(accel="bvh"))
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    n0 = rl.renderer._accumulate._cache_size()
    rl.scene.add_sphere((0, 1, 0), 0.4)  # edit -> BVH rebuild
    app.run(max_frames=1)
    rl.scene.update(int(rl.scene.active_indices()[0]), albedo=(0.9, 0.1, 0.1))
    app.run(max_frames=1)
    assert rl.renderer._accumulate._cache_size() == n0
    assert rl._spp_done == 1  # each edit restarted accumulation
    app.close()


def test_metrics_snapshot():
    app = Application(small_cfg())
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    snap = rl.metrics.snapshot()
    assert snap["frames"] == 2
    assert snap["ms_per_frame"] > 0
    assert snap["fps"] > 0
    assert snap["accumulated_spp"] == 2
    app.close()


def test_console_receives_logs():
    app = Application(small_cfg())
    from cudaraytracer_tpu.utils import logging as rtlog

    rtlog.rt_info("hello from test %d", 42)
    lines = app.console.lines()
    assert any("hello from test 42" in ln for ln in lines)
    assert app.console.lines("nonexistent-filter") == []
    app.console.clear()
    assert app.console.lines() == []
    app.close()


def test_checkpoint_resume(tmp_path):
    app = Application(small_cfg())
    rl = app.setup_default_layers()
    app.run(max_frames=3)
    rl.fly.process_keys(["w"])
    rl._cam_version = rl.fly.version  # keep accumulation for the checkpoint
    p = str(tmp_path / "ckpt")
    rl.save_state(p)
    img_before = rl.framebuffer_rgba8()

    app2 = Application(small_cfg())
    rl2 = app2.setup_default_layers()
    rl2.load_state(p)
    assert rl2._spp_done == 3
    assert rl2.fly.position == rl.fly.position
    np.testing.assert_array_equal(rl2.framebuffer_rgba8(), img_before)
    # resuming continues accumulation rather than restarting
    app2.run(max_frames=1)
    assert rl2._spp_done == 4
    app.close()
    app2.close()


def test_run_loop_survives_frame_failures():
    app = Application(small_cfg())

    class Bomb(Layer):
        def __init__(self):
            super().__init__("bomb")
            self.calls = 0

        def on_update(self):
            self.calls += 1
            raise RuntimeError("boom")

    bomb = Bomb()
    app.push_layer(bomb)
    app.run(max_frames=5)
    # three consecutive failures pause the app instead of crashing
    assert bomb.calls == 3
    assert app.paused
    app.close()


def test_frame_failures_are_counted():
    """Every failed frame is counted, so a headless render can refuse to
    write an image built from failed frames (__main__.cmd_render)."""
    app = Application(small_cfg())

    class Flaky(Layer):
        def __init__(self):
            super().__init__("flaky")
            self.calls = 0

        def on_update(self):
            self.calls += 1
            if self.calls % 2:
                raise RuntimeError("boom")

    app.push_layer(Flaky())
    app.run(max_frames=4)
    assert app.frame_failures == 2 and not app.paused
    app.close()


@pytest.mark.slow
def test_profiler_trace_hooks(tmp_path):
    app = Application(small_cfg())
    rl = app.setup_default_layers()
    logdir = str(tmp_path / "trace")
    rl.metrics.start_trace(logdir)
    app.run(max_frames=1)
    rl.metrics.stop_trace()
    import os

    assert any(os.scandir(logdir)), "profiler trace wrote nothing"
    app.close()


def _image_app(**kw):
    app = Application(small_cfg(accel="bvh", **kw))
    rl = app.setup_default_layers()
    tex = np.full((8, 8, 3), 150, np.uint8)
    slot = rl.scene.load_image_texture(tex)
    rl.scene.update(int(rl.scene.active_indices()[0]), tex_type=2,
                    tex_id=slot)
    return app, rl


def test_bvh_image_texture_scene():
    """An IMAGE-textured scene renders on the BVH path with exactly one
    sample per pixel per progressive frame (every pixel samples its
    texels exactly; no per-pixel count plane)."""
    app, rl = _image_app()
    app.run(max_frames=2)
    assert rl.cfg.accel == "bvh" and rl._spp_done == 2
    assert rl._display_divisor() == 2
    assert rl.framebuffer_rgba8()[..., :3].sum() > 0
    app.close()


def test_bvh_scene_growth():
    """Slab growth (the reference's alloc-copy-swap, CudaLayer.cpp:1131-1150)
    carries the BVH path through a capacity change: the scene and tree
    arrays change shape (one recompile), rendering continues."""
    from cudaraytracer_tpu.models.scene import LAMBERTIAN, Scene

    scene = Scene(capacity=4)
    scene.add_xz_rect((0, -0.5, 0), 50, 50, mat_type=LAMBERTIAN)
    app = Application(small_cfg(accel="bvh"))
    rl = app.setup_default_layers()
    rl.scene = scene
    rl._scene_version = -1
    app.run(max_frames=1)
    for i in range(6):  # exceeds capacity 4 -> growth
        rl.scene.add_sphere((i * 0.3, 0.6, -2.0), 0.2, mat_type=LAMBERTIAN)
    app.run(max_frames=1)
    assert rl.scene.capacity > 4 and rl.scene.num_active == 7
    assert rl._bvh.capacity >= 2 * rl.scene.capacity
    assert rl.framebuffer_rgba8()[..., :3].sum() > 0
    app.close()


def test_frame_lowering_embeds_no_device_constants():
    """The jitted frame takes every device array (scene, BVH, atlas) as an
    ARGUMENT, never a closure capture: a captured array becomes a constant
    baked into the executable, so every scene edit would recompile.
    Guard: the lowered HLO text contains no large dense constants."""
    import re

    app, rl = _image_app()
    app.run(max_frames=1)
    lowered = rl.renderer._accumulate.lower(
        rl._sd, rl._bvh, rl.fly.params(), rl.key, 2, rl._accum, 0)
    text = lowered.as_text()
    big = [m for m in re.finditer(
        r'dense<\[[^>]{2000,}|dense<"0x[0-9A-Fa-f]{2000,}', text)]
    assert not big, f"{len(big)} large dense constants embedded in lowering"
    app.close()


def test_non_progressive_image_scene_divisor():
    """Non-progressive renders take spp samples per pixel: the display
    divisor is the scalar spp (a sum-divided-by-1 bug clips the frame)."""
    app, rl = _image_app(progressive=False, spp=4)
    app.run(max_frames=1)
    assert rl._display_divisor() == 4
    img = rl.framebuffer_rgba8()
    assert (img[..., :3] >= 250).mean() < 0.5
    app.close()


def test_checkpoint_resumes_image_scene(tmp_path):
    """An image-scene checkpoint resumes on the BVH path, including one
    that still carries a per-pixel ``counts`` plane (ignored: every pixel
    took every sample)."""
    app, rl = _image_app()
    app.run(max_frames=2)
    p = str(tmp_path / "ckpt")
    rl.save_state(p)
    blob = dict(np.load(p + ".npz"))
    blob["counts"] = np.full((24, 32), 2.0, np.float32)
    np.savez_compressed(p + ".npz", **blob)
    img_before = rl.framebuffer_rgba8()

    app2, rl2 = _image_app()
    rl2.load_state(p)
    assert rl2._spp_done == 2
    np.testing.assert_array_equal(rl2.framebuffer_rgba8(), img_before)
    app2.run(max_frames=1)
    assert rl2._spp_done == 3
    app.close()
    app2.close()


def test_checkpoint_records_estimator_flags(tmp_path):
    """A checkpoint rendered under NEE (a DIFFERENT transport than the
    parity estimator) must resume under NEE even in a process started
    without it — otherwise the accumulator silently mixes estimators.
    Round-5: save_state records nee/qmc; load_state adopts them."""
    app = Application(small_cfg(nee=True))
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    p = str(tmp_path / "ckpt")
    rl.save_state(p)
    app.close()

    app2 = Application(small_cfg())  # process config: nee OFF
    rl2 = app2.setup_default_layers()
    assert rl2.renderer.nee is False
    rl2.load_state(p)
    assert rl2.cfg.nee is True and rl2.renderer.nee is True
    assert rl2._spp_done == 2
    app2.run(max_frames=1)  # continues the SAME transport
    assert rl2._spp_done == 3
    app2.close()


def test_checkpoint_without_flags_keeps_process_config(tmp_path):
    """BACK-COMPAT: a pre-round-5 checkpoint (no nee/qmc keys) resumes
    under whatever the process was started with."""
    app = Application(small_cfg())
    rl = app.setup_default_layers()
    app.run(max_frames=2)
    p = str(tmp_path / "ckpt")
    rl.save_state(p)
    app.close()
    # strip the new keys to simulate an old checkpoint
    blob = dict(np.load(p + ".npz"))
    blob.pop("nee"), blob.pop("qmc")
    np.savez_compressed(p + ".npz", **blob)

    app2 = Application(small_cfg(nee=True))
    rl2 = app2.setup_default_layers()
    rl2.load_state(p)
    assert rl2.cfg.nee is True and rl2.renderer.nee is True
    app2.close()
