"""Smoke check of the renderer on one NVIDIA GPU (or four, with --multi).

Drives the main path through the entry points a user calls, at full size,
and compares every kernel with the repo's plain reference:

  1. device   — JAX's platform, device kind and count; the card's name and
                power limit (nvidia-smi).
  2. kernel   — the closest-hit kernel (ops/bvh_kernel.py) against XLA's
                bvh_closest_hit on 1280x720 primary rays plus one bounce of
                scattered rays, on rtow_final, cornell, mesh_smooth and
                terrain_big; and the brute intersect.hit_scene against the
                BVH path on rtow_final at 320x180.
  3. render   — `render` (cudaraytracer_tpu.__main__.main) of rtow_final at
                1280x720, depth 12, 8 progressive frames, to .npy: finite and
                non-black; ms/frame and Mrays/s.
  4. image    — 320x180, 16 spp, same seeds: accel=bvh (the kernel) against
                accel=brute (the plain reference), per 16x16 block mean.
  5. largest  — `render` of terrain_big (20,002 triangles) at 1280x720,
                4 frames, accel=auto: finite; ms/frame.
  6. viewer   — `serve` in-process on an ephemeral port: /state and
                /frame.png three times; the frame counter advances and the
                PNGs are well formed.

``--multi`` runs only the four-GPU path instead: the sharded renderer
(parallel/tiling.py) on a 2x2 (rows x samples) mesh, rtow_final at
1280x720, depth 12, 4 spp, each row band against a single-GPU render of
the same band and seeds.

Every phase raises on failure, so any failure exits non-zero; the last line
of a passing run is one JSON object naming the device.  Without a GPU the
script exits non-zero before printing any result.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "smoke_out")

# Tolerances (section D of the kernel's contract, with their reasons):
# hit mask and primitive agree on >= 99.99% of rays — the kernel and XLA
# both run f32 but contract multiply-adds differently, so a ray that
# grazes an edge or ties two primitives may resolve either way;
AGREE_MIN = 0.9999
# where the primitive agrees, |dt| <= 1e-4 * max(t, 1) on >= 99.99% of
# them — the same arithmetic up to FMA contraction and order;
T_REL_TIGHT = 1e-4
# and |dt| <= 2e-3 * max(t, 1) on all of them: near-tangent hits on large
# spheres (the radius-1000 ground of rtow_final) cancel in disc = b*b - a*c,
# whose f32 rounding error (~eps * b*b) moves t by up to ~sqrt(eps) * t.
T_REL_LOOSE = 2e-3
# The brute reference is held to looser bounds: it expands |o - c|^2 into
# o.o - 2 o.c + c.c (its matmul form, ops/intersect.py), which loses
# ~eps * |c|^2 to cancellation.  Its primitive agrees with the BVH's on
# >= 99.9% of rays (the rest are silhouette grazes, and bounce rays whose
# own surface lands within rounding of t_min) and t to the loose bound.
AGREE_MIN_BRUTE = 0.999
# image phase: per 16x16-block mean radiance over 16 spp with identical RNG
# keys agrees to 1e-2 (absolute, radiance units; rtow_final's blocks average
# ~0.3-0.9): only rays that resolve a tie differently diverge, and each
# diverged sample moves its block mean by at most its radiance / 4096.
BLOCK_TOL = 1e-2
# --multi: each band equals the single-GPU band up to the order in which
# the psum adds the two sample streams.
BAND_RTOL, BAND_ATOL = 1e-5, 1e-4
FULL = (1280, 720)
SMALL = (320, 180)
DEPTH = 12


def log(*a):
    print(*a, flush=True)


class Smoke:
    def __init__(self):
        self.card = ""

    # ------------------------------------------------------------ helpers
    def scene(self, name):
        from cudaraytracer_tpu.models import scenes
        from cudaraytracer_tpu.models.bvh import build_bvh

        make_scene, make_cam = scenes.SCENES[name]
        sc = make_scene()
        return sc, sc.device(), build_bvh(sc), make_cam(), \
            scenes.camera_model_for(name)

    @staticmethod
    def kernel_hit(sd, bvh, org, dirn):
        from cudaraytracer_tpu.ops.bvh_kernel import (bvh_closest_hit_kernel,
                                                      pack_tables)

        kw = (dict(edge1=sd.edge1, edge2=sd.edge2)
              if sd.has_triangles else {})
        return bvh_closest_hit_kernel(
            org, dirn, pack_tables(bvh, sd.prim_type, sd.center, sd.size,
                                   **kw), t_min=1e-3)

    @staticmethod
    def compare_hits(name, ref, got, tight_t=True, agree_min=AGREE_MIN):
        import numpy as np

        _, t_ref, p_ref = (np.asarray(x) for x in ref)
        _, t_got, p_got = (np.asarray(x) for x in got)
        same = p_ref == p_got  # -1 = miss, so this covers the hit mask
        agree = float(same.mean())
        hit = same & (p_ref >= 0)
        rel = np.abs(t_ref - t_got)[hit] / np.maximum(np.abs(t_ref[hit]), 1)
        tight = float((rel <= T_REL_TIGHT).mean()) if rel.size else 1.0
        worst = float(rel.max()) if rel.size else 0.0
        log(f"  {name}: {p_ref.size} rays, hit {float((p_ref >= 0).mean()):.4f}"
            f", prim agree {agree:.6f}, |dt| tight share {tight:.6f}, "
            f"worst rel |dt| {worst:.3g}")
        assert agree >= agree_min, f"{name}: prim agreement {agree}"
        assert tight >= AGREE_MIN or not tight_t, \
            f"{name}: tight-t share {tight}"
        assert worst <= T_REL_LOOSE, f"{name}: worst rel |dt| {worst}"

    def rays(self, sd, bvh, cam, model, width, height):
        """Pixel-jittered primary rays plus one bounce scattered off their
        first hits (the renderer's own hit record and scatter)."""
        import jax
        import jax.numpy as jnp

        from cudaraytracer_tpu.models.camera import RAY_GENERATORS
        from cudaraytracer_tpu.ops import intersect, materials
        from cudaraytracer_tpu.ops.bvh_traverse import bvh_closest_hit
        from cudaraytracer_tpu.utils import rng as rngu

        key = jax.random.PRNGKey(11)
        org, dirn = RAY_GENERATORS[model](cam, width, height, key, y0=0,
                                          tile_h=height)
        kw = (dict(edge1=sd.edge1, edge2=sd.edge2)
              if sd.has_triangles else {})
        hit, t, idx = jax.jit(lambda o, d: bvh_closest_hit(
            o, d, bvh, sd.prim_type, sd.center, sd.size, **kw))(org, dirn)
        rec = intersect.make_hit_record(org, dirn, hit, t, idx, sd.prim_type,
                                        sd.center, sd.size, **kw)
        safe = jnp.maximum(idx, 0)
        r = org.shape[0]
        k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
        sc = materials.scatter(
            dirn, rec.point, rec.normal, sd.mat_type[safe], sd.fuzz[safe],
            sd.ior[safe], sd.light[safe], jnp.zeros_like(org),
            rngu.in_unit_sphere(k1, (r,)), jax.random.uniform(k2, (r,)))
        go = hit & sc.scattered
        org2 = jnp.where(go[:, None], rec.point, org)
        dir2 = jnp.where(go[:, None], sc.direction, dirn)
        return (jnp.concatenate([org, org2]), jnp.concatenate([dirn, dir2]))

    def timed(self, fn, *args, reps=5):
        import jax

        jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2] * 1e3

    def render_cli(self, scene, frames, out):
        from cudaraytracer_tpu.__main__ import main

        w, h = FULL
        return main(["render", "--scene", scene, "--width", str(w),
                     "--height", str(h), "--max-depth", str(DEPTH),
                     "--frames", str(frames), "-o", out])

    # ------------------------------------------------------------- phases
    def phase_device(self):
        from cudaraytracer_tpu.utils.runtime import (device_summary,
                                                     gpu_name_and_power_limit)

        d = device_summary()
        log(f"  platform {d['platform']}, kind {d['kind']}, count {d['count']}")
        self.card = gpu_name_and_power_limit()
        log("  card name, power limit (nvidia-smi):")
        log(self.card or "no nvidia-smi")
        return d

    def phase_kernel(self):
        import jax

        from cudaraytracer_tpu.ops import intersect
        from cudaraytracer_tpu.ops.bvh_traverse import bvh_closest_hit

        w, h = FULL
        for name in ("rtow_final", "cornell", "mesh_smooth", "terrain_big"):
            sc, sd, bvh, cam, model = self.scene(name)
            org, dirn = self.rays(sd, bvh, cam, model, w, h)
            kw = (dict(edge1=sd.edge1, edge2=sd.edge2)
                  if sd.has_triangles else {})
            xla = jax.jit(lambda o, d: bvh_closest_hit(
                o, d, bvh, sd.prim_type, sd.center, sd.size, **kw))
            ker = jax.jit(lambda o, d: self.kernel_hit(sd, bvh, o, d))
            self.compare_hits(f"{name} {w}x{h} primary+bounce",
                              xla(org, dirn), ker(org, dirn))
            log(f"    closest hit of {org.shape[0]} rays: kernel "
                f"{self.timed(ker, org, dirn):.3f} ms, XLA "
                f"{self.timed(xla, org, dirn):.3f} ms ({self.card})")
        sc, sd, bvh, cam, model = self.scene("rtow_final")
        org, dirn = self.rays(sd, bvh, cam, model, *SMALL)
        brute = jax.jit(lambda o, d: intersect.hit_scene(
            o, d, sd.prim_type, sd.center, sd.size, sd.active, t_min=1e-3))
        self.compare_hits("rtow_final %dx%d brute vs BVH kernel" % SMALL,
                          brute(org, dirn),
                          jax.jit(lambda o, d: self.kernel_hit(
                              sd, bvh, o, d))(org, dirn), tight_t=False,
                          agree_min=AGREE_MIN_BRUTE)

    def phase_render(self):
        import numpy as np

        from cudaraytracer_tpu.models import scenes
        from cudaraytracer_tpu.models.bvh import build_bvh
        from cudaraytracer_tpu.models.renderer import Renderer
        from cudaraytracer_tpu.utils import rng as rngu

        out = os.path.join(OUT_DIR, "rtow_final.npy")
        stats = self.render_cli("rtow_final", 8, out)
        img = np.load(out)
        w, h = FULL
        assert img.shape == (h, w, 3), img.shape
        assert np.isfinite(img).all(), "non-finite radiance"
        assert float(img.mean()) > 0.01, f"black frame (mean {img.mean()})"
        # rays of one 1-spp frame (primary + bounces, the renderer's count)
        sc = scenes.rtow_final_scene()
        r = Renderer(w, h, camera_model="look_at")
        _, nrays = r.render(sc.device(), scenes.rtow_final_camera(
            aperture=0.0), rngu.base_key(), spp=1, max_depth=DEPTH,
            bvh=build_bvh(sc), with_stats=True)
        ms = stats["ms_per_frame"]
        log(f"  rtow_final {w}x{h} depth {DEPTH}, 8 frames: "
            f"mean radiance {float(img.mean()):.4f}; first frame "
            f"{stats['first_frame_s']:.2f} s (compile included)")
        log(f"  {ms:.3f} ms/frame, {float(nrays) / ms / 1e3:.2f} Mrays/s "
            f"({float(nrays):.0f} rays/frame) on {self.card}")

    def phase_image(self):
        import jax
        import numpy as np

        from cudaraytracer_tpu.models.bvh import make_bvh_hit_fn
        from cudaraytracer_tpu.models.renderer import render_radiance
        from cudaraytracer_tpu.utils import rng as rngu

        sc, sd, bvh, cam, model = self.scene("rtow_final")
        w, h = SMALL
        spp = 16

        def run(sd, bvh, key):
            hit_fn = None if bvh is None else make_bvh_hit_fn(bvh, sd)
            return render_radiance(sd, cam, key, spp, DEPTH, width=w,
                                   height=h, camera_model=model,
                                   hit_fn=hit_fn) / spp

        run = jax.jit(run)
        got = np.asarray(run(sd, bvh, rngu.base_key()))
        ref = np.asarray(run(sd, None, rngu.base_key()))

        def blocks(a):
            return a[: h // 16 * 16, : w // 16 * 16].reshape(
                h // 16, 16, w // 16, 16, 3).mean((1, 3))

        err = np.abs(blocks(got) - blocks(ref))
        pix = float((np.abs(got - ref).max(-1) > 1e-4).mean())
        log(f"  rtow_final {w}x{h} {spp} spp: max block |d mean| "
            f"{float(err.max()):.3g} (tolerance {BLOCK_TOL}), mean "
            f"{float(err.mean()):.3g}; pixels differing > 1e-4: {pix:.4f}")
        assert np.isfinite(got).all() and np.isfinite(ref).all()
        assert float(err.max()) <= BLOCK_TOL

    def phase_largest(self):
        import numpy as np

        out = os.path.join(OUT_DIR, "terrain_big.npy")
        stats = self.render_cli("terrain_big", 4, out)
        img = np.load(out)
        assert np.isfinite(img).all(), "non-finite radiance"
        assert float(img.mean()) > 0.01, "black frame"
        w, h = FULL
        log(f"  terrain_big {w}x{h} depth {DEPTH}, 4 frames: mean "
            f"radiance {float(img.mean()):.4f}; first frame "
            f"{stats['first_frame_s']:.2f} s (compile included)")
        log(f"  {stats['ms_per_frame']:.3f} ms/frame on {self.card}")

    def phase_viewer(self):
        import struct

        from cudaraytracer_tpu.config import RenderConfig
        from cudaraytracer_tpu.viewer.app import Application
        from cudaraytracer_tpu.viewer.server import ViewerServer

        w, h = FULL
        cfg = RenderConfig(width=w, height=h, scene="rtow_final",
                           camera_model="look_at", max_depth=DEPTH)
        app = Application(cfg)
        app.setup_default_layers()
        server = ViewerServer(app, port=0, data_dir=OUT_DIR)
        server.start()
        loop = threading.Thread(target=app.run, daemon=True)
        loop.start()
        base = f"http://127.0.0.1:{server.port}"
        try:
            frames = []
            for _ in range(3):
                deadline = time.time() + 300
                while True:
                    with urllib.request.urlopen(base + "/state",
                                                timeout=60) as r:
                        state = json.loads(r.read())
                    n = state["metrics"]["frames"]
                    if n > (frames[-1] if frames else 0):
                        break
                    assert time.time() < deadline, "viewer made no frame"
                    time.sleep(0.05)
                with urllib.request.urlopen(base + "/frame.png",
                                            timeout=60) as r:
                    png = r.read()
                    ctype = r.headers["Content-Type"]
                assert ctype == "image/png", ctype
                assert png[:8] == b"\x89PNG\r\n\x1a\n", "bad PNG signature"
                pw, ph = struct.unpack(">II", png[16:24])
                assert (pw, ph) == (w, h), (pw, ph)
                frames.append(n)
            log(f"  /state frame counter {frames}, /frame.png {w}x{h} "
                f"({len(png)} bytes)")
            assert frames[0] < frames[1] < frames[2], frames
        finally:
            app.running = False
            loop.join(timeout=120)
            server.stop()
            app.close()
        assert not loop.is_alive(), "render loop did not stop"

    def phase_multi(self):
        import jax
        import numpy as np

        from cudaraytracer_tpu.models.bvh import make_bvh_hit_fn
        from cudaraytracer_tpu.models.renderer import render_radiance
        from cudaraytracer_tpu.parallel import make_mesh, render_sharded
        from cudaraytracer_tpu.utils import rng as rngu

        devices = jax.devices()
        assert len(devices) >= 4, f"--multi needs 4 devices, have {len(devices)}"
        mesh = make_mesh(n_rows=2, n_samples=2, devices=devices[:4])
        sc, sd, bvh, cam, model = self.scene("rtow_final")
        w, h = FULL
        spp = 4
        key = rngu.base_key()

        @jax.jit
        def sharded(sd, bvh, key):
            return render_sharded(sd, cam, key, spp, DEPTH, width=w,
                                  height=h, mesh=mesh, camera_model=model,
                                  bvh=bvh)

        ms = self.timed(sharded, sd, bvh, key, reps=3)
        out = np.asarray(sharded(sd, bvh, key))
        assert np.isfinite(out).all()
        band, local = h // 2, spp // 2

        @jax.jit
        def single(sd, bvh, key, y0, offset):
            return render_radiance(
                sd, cam, key, local, DEPTH, width=w, height=h,
                camera_model=model, y0=y0, tile_h=band, sample_offset=offset,
                hit_fn=make_bvh_hit_fn(bvh, sd))

        for b in range(2):
            want = sum(np.asarray(single(sd, bvh, key, b * band, s * local))
                       for s in range(2))
            got = out[b * band:(b + 1) * band]
            diff = float(np.abs(got - want).max())
            log(f"  band {b} (rows {b * band}-{(b + 1) * band - 1}): max "
                f"|sharded - single| {diff:.3g}")
            np.testing.assert_allclose(got, want, rtol=BAND_RTOL,
                                       atol=BAND_ATOL)
        log(f"  2x2 mesh rtow_final {w}x{h} depth {DEPTH} {spp} spp: "
            f"{ms:.3f} ms/frame on 4 x {self.card.splitlines()[0] if self.card else '?'}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-GPU sharded path")
    args = p.parse_args(argv)

    t_start = time.perf_counter()
    from cudaraytracer_tpu.utils.runtime import (enable_compile_cache,
                                                 select_backend)

    select_backend()
    enable_compile_cache()
    os.makedirs(OUT_DIR, exist_ok=True)
    s = Smoke()
    phases = [("device", s.phase_device)]
    if args.multi:
        phases.append(("multi", s.phase_multi))
    else:
        phases += [("kernel", s.phase_kernel), ("render", s.phase_render),
                   ("image", s.phase_image), ("largest", s.phase_largest),
                   ("viewer", s.phase_viewer)]
    device = None
    for i, (name, fn) in enumerate(phases, 1):
        log(f"[{i}/{len(phases)}] {name}")
        t0 = time.perf_counter()
        r = fn()
        device = r if name == "device" else device
        log(f"  {name} passed in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
