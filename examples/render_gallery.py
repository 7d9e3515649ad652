"""Render every built-in scene to PNG through the production path (the
BVH with the closest-hit kernel on a GPU).

Usage: python examples/render_gallery.py [--cpu] [--width 320] [--spp 16]
Writes examples/gallery/<scene>.png.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: require a GPU)")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=180)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--only", default=None,
                    help="render just this registered scene")
    ap.add_argument("--nee", action="store_true",
                    help="render with the book-3 mixture estimator "
                         "(writes <scene>_nee.png)")
    args = ap.parse_args()

    from cudaraytracer_tpu.utils.runtime import (enable_compile_cache,
                                                 select_backend)

    select_backend(cpu=args.cpu)
    enable_compile_cache()

    import numpy as np

    from cudaraytracer_tpu.models import scenes
    from cudaraytracer_tpu.models.bvh import build_bvh
    from cudaraytracer_tpu.models.renderer import Renderer
    from cudaraytracer_tpu.ops.pack import pack_rgba8
    from cudaraytracer_tpu.utils import rng as rngu
    from cudaraytracer_tpu.utils.image import save_png

    outdir = os.path.join(os.path.dirname(__file__), "gallery")
    os.makedirs(outdir, exist_ok=True)
    for name in scenes.SCENES:
        if args.only and name != args.only:
            continue
        cam_model = scenes.camera_model_for(name)
        make_scene, make_cam = scenes.SCENES[name]
        scene = make_scene()
        t0 = time.perf_counter()
        r = Renderer(args.width, args.height, camera_model=cam_model,
                     nee=args.nee)
        rad = r.render(scene.device(), make_cam(), rngu.base_key(),
                       spp=args.spp, max_depth=args.depth,
                       bvh=build_bvh(scene))
        img = np.asarray(pack_rgba8(rad, args.spp))
        dt = time.perf_counter() - t0
        suffix = "_nee" if args.nee else ""
        path = os.path.join(outdir, f"{name}{suffix}.png")
        # two_plane framebuffers are bottom-up; look_at is top-down
        save_png(path, img, flip_vertical=(cam_model == "two_plane"))
        print(f"{name}: {dt:.1f}s (compile included) -> {path}")


if __name__ == "__main__":
    main()
