"""Application shell: layers, run loop, progressive rendering.

Re-architecture of the reference's core runtime (reference:
CudaRayTracer/src/Core/Application.cpp:14-62 singleton + run loop,
Core/Layer.h:6-33 + Core/LayerStack.cpp:5-40 layer lifecycle, and the
CudaLayer frame orchestration, Cuda/CudaLayer.cpp:364-387):

  * ``Layer``/``LayerStack`` keep the Hazel-style on_attach/on_detach/
    on_update lifecycle so the viewer, renderer, and future plugins
    compose the same way the reference's do.
  * ``RenderLayer`` is the CudaLayer analog: owns the scene, camera,
    progressive accumulator and jitted renderer; one ``on_update`` = one
    1-spp progressive sample (the BASELINE.json north-star loop), with
    accumulation reset on any camera/scene edit (the reference instead
    recomputes all 36 spp every frame, Kernel.cu:137).
  * ``Application.run`` drives layers at an optional frame cap, headless
    (N frames) or forever; pause maps to the reference's P key
    (Core/Window.h:24).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..config import RenderConfig
from ..models import scenes as scene_lib
from ..models.bvh import build_bvh
from ..models.camera import FlyCamera
from ..models.renderer import Renderer
from ..ops.pack import to_rgba8, tonemap
from ..utils import logging as rtlog
from ..utils import rng as rngu
from .console import Console
from .metrics import Metrics


class Layer:
    """Core/Layer.h:6-33 analog."""

    def __init__(self, name: str = "Layer"):
        self.name = name

    def on_attach(self, app: "Application"):
        pass

    def on_detach(self):
        pass

    def on_update(self):
        pass


class LayerStack:
    """Core/LayerStack.h:7-55 analog: layers before overlays."""

    def __init__(self):
        self._layers: list[Layer] = []
        self._insert_index = 0

    def push_layer(self, layer: Layer):
        self._layers.insert(self._insert_index, layer)
        self._insert_index += 1

    def push_overlay(self, layer: Layer):
        self._layers.append(layer)

    def pop_layer(self, layer: Layer):
        i = self._layers.index(layer)
        if i < self._insert_index:
            self._insert_index -= 1
        self._layers.pop(i)
        layer.on_detach()

    def __iter__(self):
        return iter(self._layers)


class RenderLayer(Layer):
    """The CudaLayer analog: owns scene + camera + progressive state."""

    def __init__(self, cfg: RenderConfig, scene=None, fly: Optional[FlyCamera] = None):
        super().__init__("RenderLayer")
        self.cfg = cfg
        make_scene, make_cam_params = scene_lib.SCENES[cfg.scene]
        self.scene = scene if scene is not None else make_scene()
        self.fly = fly or FlyCamera()
        if scene is None and fly is None:
            # start the fly camera at the scene's REGISTERED pose (each
            # SCENES entry ships a camera; previously only rtow* scenes
            # got a pose and e.g. mirror_room opened BEHIND its light)
            self._pose_fly_at(make_cam_params())
        self.key = rngu.base_key(cfg.seed)
        self.metrics = Metrics()
        self.metrics.width, self.metrics.height = cfg.width, cfg.height
        self._scene_version = -1
        self._cam_version = -1
        self._frame_index = 0
        self._spp_done = 0
        self.renderer: Renderer | None = None
        self._bvh = None
        self._sd = None
        self._accum = None

    def _pose_fly_at(self, cam0):
        """Point the fly camera at a registered CameraParams pose."""
        import math

        origin = [float(v) for v in np.asarray(cam0.origin)]
        f = np.asarray(cam0.forward, np.float64)
        f = f / max(float(np.linalg.norm(f)), 1e-12)
        self.fly.position = origin
        self.fly.home = tuple(origin)
        self.fly.pitch = math.degrees(math.asin(max(-1.0, min(1.0, f[1]))))
        self.fly.yaw = math.degrees(math.atan2(f[2], f[0])) % 360.0
        self.fly.fov_deg = math.degrees(float(cam0.fov))
        self.fly._update_orientation()
        self.fly.version += 1

    def set_scene(self, name: str):
        """Switch to a registered built-in scene at runtime (the viewer's
        scene combo; BEYOND-REFERENCE — the reference bakes one world at
        startup, CudaLayer.cpp:103-256).  Re-poses the fly camera and, when
        the new scene's authored projection differs, rebuilds the renderer
        (same accepted recompile cost as a resize)."""
        make_scene, make_cam_params = scene_lib.SCENES[name]
        self.scene = make_scene()
        self.cfg.scene = name
        self._pose_fly_at(make_cam_params())
        model = scene_lib.camera_model_for(name)
        if model != self.cfg.camera_model:
            self.cfg.camera_model = model
            self.renderer = self._make_renderer()
        self._scene_version = -1  # force a full device re-sync
        rtlog.rt_info("Scene switched to %s (camera=%s)", name, model)

    # -------------------------------------------------------- lifecycle
    def on_attach(self, app: "Application"):
        self.app = app
        cfg = self.cfg
        if cfg.accel == "auto":
            # the BVH path: the closest-hit kernel on a GPU, the XLA
            # traversal on the CPU (models/bvh.py::resolve_traversal)
            cfg.accel = "bvh"
        rtlog.rt_info("RenderLayer: %dx%d scene=%s accel=%s camera=%s",
                      cfg.width, cfg.height, cfg.scene, cfg.accel, cfg.camera_model)
        self.renderer = self._make_renderer()
        import jax

        self.metrics.build_mode = "debug" if cfg.debug_nans else "release"
        self.metrics.backend = jax.default_backend()
        self.metrics.accel = cfg.accel
        self._accum = self.renderer.zeros_accum()
        self._sync_scene()

    def on_detach(self):
        rtlog.rt_info("RenderLayer detached after %d frames", self._frame_index)

    # -------------------------------------------------------- state sync
    def _make_renderer(self) -> Renderer:
        """The one place a Renderer is constructed from cfg — on_attach,
        set_scene, resize, and the static-flag toggles all route here so
        no site can drop a flag the others carry."""
        cfg = self.cfg
        return Renderer(
            cfg.width, cfg.height, camera_model=cfg.camera_model,
            t_min=cfg.t_min, block=cfg.block,
            nee=getattr(cfg, "nee", False),
            nee_p=getattr(cfg, "nee_p", 0.5),
            qmc=getattr(cfg, "qmc", False),
        )

    def rebuild_renderer(self):
        """Rebuild the renderer after a STATIC cfg flag flips (the
        viewer's NEE/QMC toggles): the Renderer captures nee/qmc at
        construction, so frames would otherwise keep the old estimator
        while /state reports the new flag."""
        self.renderer = self._make_renderer()
        self._scene_version = -1

    def _sync_scene(self):
        if self.scene.version != self._scene_version:
            self._sd = self.scene.device()
            self._bvh = (build_bvh(self.scene) if self.cfg.accel == "bvh"
                         else None)
            self._scene_version = self.scene.version
            self.reset_accumulation()
        if self.fly.version != self._cam_version:
            self._cam_version = self.fly.version
            self.reset_accumulation()

    def reset_accumulation(self):
        """Accumulation restart on edit — the progressive analog of the
        reference's full re-render after every UI drag."""
        if self.renderer is not None:
            self._accum = self.renderer.zeros_accum()
        self._spp_done = 0

    def resize(self, width: int, height: int):
        """Viewport resize: rebuild the renderer at the new shape (the
        analog of OnImGuiResize freeing + re-initializing the framebuffer
        and RNG buffers, CudaLayer.cpp:689-717).  One recompile per new
        size; no RNG re-seed needed (counter-based keys)."""
        width, height = int(width), int(height)
        if (width, height) == (self.cfg.width, self.cfg.height):
            return
        rtlog.rt_info("Resize %dx%d -> %dx%d",
                      self.cfg.width, self.cfg.height, width, height)
        self.cfg.width, self.cfg.height = width, height
        self.metrics.width, self.metrics.height = width, height
        self.renderer = self._make_renderer()
        self.reset_accumulation()

    # -------------------------------------------------------- frame
    def on_update(self):
        self._sync_scene()
        cfg = self.cfg
        self.metrics.frame_start()
        cam = self.fly.params(aperture=cfg.aperture, focus_dist=cfg.focus_dist)
        fkey = rngu.frame_key(self.key, self._frame_index)
        if cfg.progressive:
            self._accum = self.renderer.accumulate(
                self._sd, cam, fkey, cfg.max_depth, self._accum,
                bvh=self._bvh, sample_offset=self._spp_done
            )
            self._spp_done += 1
            rays = cfg.width * cfg.height
        else:
            rad, nrays = self.renderer.render(
                self._sd, cam, fkey, spp=cfg.spp, max_depth=cfg.max_depth,
                bvh=self._bvh, with_stats=True,
            )
            self._accum = rad
            self._spp_done = cfg.spp
            rays = float(nrays)
        # one frame in flight: the frame time the metrics report is the
        # device's, and the dispatch queue stays bounded in `serve`
        self._accum.block_until_ready()
        self._frame_index += 1
        self.metrics.accumulated_spp = self._spp_done
        self.metrics.frame_end(rays)

    # -------------------------------------------------------- checkpoint
    def save_state(self, path: str):
        """Checkpoint the full render session: scene + camera + the
        progressive accumulator (the reference cannot persist anything but
        the ImGui dock layout — SURVEY.md §5 names this as a gap)."""
        self.scene.save(path + ".scene.json")
        np.savez_compressed(
            path,
            accum=np.asarray(self._accum),
            spp=self._spp_done,
            frame_index=self._frame_index,
            position=np.asarray(self.fly.position),
            yaw=self.fly.yaw, pitch=self.fly.pitch, fov=self.fly.fov_deg,
            # the estimator/sampler the accumulator was rendered under —
            # resume must continue with the SAME transport (NEE is a
            # different lambertian transport than the parity default)
            nee=bool(getattr(self.cfg, "nee", False)),
            qmc=bool(getattr(self.cfg, "qmc", False)),
        )
        rtlog.rt_info("Checkpoint saved to %s (%d spp)", path, self._spp_done)

    def load_state(self, path: str):
        """Resume a checkpointed session: accumulation continues where it
        left off instead of restarting from 1 spp."""
        from ..models.scene import Scene

        self.scene = Scene.load(path + ".scene.json")
        if not path.endswith(".npz"):
            path = path + ".npz"
        blob = np.load(path)
        self.fly.position = [float(v) for v in blob["position"]]
        self.fly.yaw = float(blob["yaw"])
        self.fly.pitch = float(blob["pitch"])
        self.fly.fov_deg = float(blob["fov"])
        self.fly._update_orientation()
        # the estimator flags are part of the accumulated ESTIMATE: a
        # checkpoint rendered under NEE (a different transport) must not
        # be continued with the parity estimator, so resume adopts the
        # saved flags (older checkpoints lack them: keep process config)
        want_nee = bool(blob["nee"]) if "nee" in blob \
            else bool(getattr(self.cfg, "nee", False))
        want_qmc = bool(blob["qmc"]) if "qmc" in blob \
            else bool(getattr(self.cfg, "qmc", False))
        if (want_nee != bool(getattr(self.cfg, "nee", False))
                or want_qmc != bool(getattr(self.cfg, "qmc", False))):
            self.cfg.nee, self.cfg.qmc = want_nee, want_qmc
            self.renderer = self._make_renderer()
            rtlog.rt_info("Resume adopts checkpoint estimator flags: "
                          "nee=%s qmc=%s", want_nee, want_qmc)
        # sync versions BEFORE restoring the accumulator so the next
        # _sync_scene doesn't wipe it
        self._scene_version = self.scene.version
        self._cam_version = self.fly.version
        self._sd = self.scene.device()
        self._bvh = build_bvh(self.scene) if self.cfg.accel == "bvh" else None
        import jax.numpy as jnp

        self._accum = jnp.asarray(blob["accum"])
        self._spp_done = int(blob["spp"])
        self._frame_index = int(blob["frame_index"])
        rtlog.rt_info("Checkpoint loaded from %s (resuming at %d spp)",
                      path, self._spp_done)

    # -------------------------------------------------------- output
    def _gbuffer(self):
        """First-hit feature buffers for the display-time denoiser, cached
        per (scene, camera) version — they are deterministic functions of
        those alone, so flying recomputes once per camera bump and
        accumulation frames pay nothing (ops/gbuffer.py).  The first hit
        goes through the renderer's own BVH when it has one."""
        key = (self._scene_version, self._cam_version,
               self.cfg.width, self.cfg.height, self.cfg.camera_model)
        if getattr(self, "_gb_key", None) != key:
            from ..ops.gbuffer import gbuffer_step

            cam = self.fly.params(aperture=self.cfg.aperture,
                                  focus_dist=self.cfg.focus_dist)
            self._gb = gbuffer_step(
                self.cfg.width, self.cfg.height, self.cfg.camera_model,
                t_min=self.cfg.t_min, block=self.cfg.block,
            )(self._sd, cam, self._bvh)
            self._gb_key = key
        return self._gb

    def _denoised_mean(self):
        """Denoised mean LINEAR radiance f32[H,W,3] (device array,
        render-oriented).  Display-time only: the accumulator is never
        touched, so toggling the denoiser is instant and lossless."""
        from ..ops.denoise import denoise_step

        gb = self._gbuffer()
        mean = self._accum / self._display_divisor()
        step = denoise_step(self.cfg.height, self.cfg.width,
                            int(getattr(self.cfg, "denoise_iters", 4)))
        return step(mean, gb.normal, gb.albedo, gb.depth, None)

    def framebuffer_rgba8(self, scale: int = 1) -> np.ndarray:
        """uint8[H/scale,W/scale,4], display-oriented (row 0 = top).

        The two_plane camera renders in the reference's GL convention
        (row 0 = bottom) and is flipped at display time like the
        reference's uv blit (CudaLayer.cpp:402); look_at renders row 0 =
        top already.  ``scale`` downsamples ON DEVICE before the host
        transfer."""
        if getattr(self.cfg, "denoise", False):
            acc, div = self._denoised_mean(), 1
        else:
            acc, div = self._accum, self._display_divisor()
        if scale > 1:
            acc = acc[:: int(scale), :: int(scale)]
        img = np.asarray(to_rgba8(tonemap(acc, div)))
        return img[::-1] if self.cfg.camera_model == "two_plane" else img

    def display_float(self) -> np.ndarray:
        if getattr(self.cfg, "denoise", False):
            img = np.asarray(tonemap(self._denoised_mean(), 1))
        else:
            img = np.asarray(tonemap(self._accum, self._display_divisor()))
        return img[::-1] if self.cfg.camera_model == "two_plane" else img

    def radiance_mean(self) -> np.ndarray:
        """Mean LINEAR radiance f32[H,W,3], display-oriented — the HDR
        output (no gamma, no clamp; the reference can't export at all).
        With cfg.denoise the export is the denoised linear radiance."""
        if getattr(self.cfg, "denoise", False):
            img = np.asarray(self._denoised_mean(), dtype=np.float32)
        else:
            img = np.asarray(self._accum / self._display_divisor(),
                             dtype=np.float32)
        return img[::-1] if self.cfg.camera_model == "two_plane" else img

    def aov(self) -> dict:
        """G-buffer AOVs as display-oriented numpy arrays: ``normal``
        f32[H,W,3] (unit, zeros on miss), ``albedo`` f32[H,W,3] (first-hit
        texture color, sky on miss), ``depth`` f32[H,W] (hit t, 0 on
        miss).  Beyond-reference: the CUDA kernel writes only the beauty
        image (Kernel.cu:102-158)."""
        gb = self._gbuffer()
        flip = self.cfg.camera_model == "two_plane"
        return {k: (np.asarray(v)[::-1] if flip else np.asarray(v))
                for k, v in gb._asdict().items()}

    def _display_divisor(self):
        """Accumulated samples per pixel (every pixel takes every sample)."""
        return max(self._spp_done, 1)


class Application:
    """Application.cpp:14-62 analog: owns the layer stack and the run loop."""

    _instance: "Application | None" = None

    def __init__(self, cfg: RenderConfig | None = None):
        rtlog.init()
        self.cfg = cfg or RenderConfig()
        self.console = Console()
        self.layers = LayerStack()
        self.running = True
        self.paused = False  # the P-key pause (Window.h:24)
        self.render_layer: RenderLayer | None = None
        self.frame_failures = 0  # frames that raised, over the app's life
        Application._instance = self

    @classmethod
    def get(cls) -> "Application":
        assert cls._instance is not None
        return cls._instance

    def push_layer(self, layer: Layer):
        self.layers.push_layer(layer)
        layer.on_attach(self)

    def push_overlay(self, layer: Layer):
        self.layers.push_overlay(layer)
        layer.on_attach(self)

    def setup_default_layers(self, scene=None):
        self.render_layer = RenderLayer(self.cfg, scene=scene)
        self.push_overlay(self.render_layer)
        return self.render_layer

    def toggle_pause(self):
        self.paused = not self.paused
        rtlog.rt_info("Rendering %s", "paused" if self.paused else "resumed")

    def run(self, max_frames: Optional[int] = None, frame_cap_hz: float = 0.0):
        """The Run() loop (Application.cpp:44-62): update every layer per
        frame; headless when max_frames is given."""
        n = 0
        consecutive_failures = 0
        while self.running and (max_frames is None or n < max_frames):
            t0 = time.perf_counter()
            if not self.paused:
                try:
                    for layer in self.layers:
                        layer.on_update()
                    consecutive_failures = 0
                except Exception as e:  # failure detection: pause, don't die
                    consecutive_failures += 1
                    self.frame_failures += 1
                    rtlog.rt_error("Frame failed (%d in a row): %s",
                                   consecutive_failures, e)
                    if consecutive_failures >= 3:
                        rtlog.rt_error("Pausing after repeated frame failures")
                        self.paused = True
                n += 1
            if frame_cap_hz > 0:
                budget = 1.0 / frame_cap_hz - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)
            if self.paused:
                if max_frames is not None:
                    break  # headless runs don't spin-wait for unpause
                time.sleep(0.01)
        return n

    def close(self):
        self.running = False
        for layer in self.layers:
            layer.on_detach()
        self.console.close()
