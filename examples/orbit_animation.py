"""Interactive-loop demo: orbit the camera around the default scene and
write an animated GIF — exercises the progressive accumulate/reset path the
way a user dragging the mouse does.

Usage: python examples/orbit_animation.py [--cpu] [--frames 24]
Needs Pillow (GIF writing).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: require a GPU)")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=144)
    args = ap.parse_args()

    from cudaraytracer_tpu.utils.image import require_pillow
    from cudaraytracer_tpu.utils.runtime import (enable_compile_cache,
                                                 select_backend)

    select_backend(cpu=args.cpu)
    enable_compile_cache()
    Image = require_pillow("writing the GIF")

    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application

    cfg = RenderConfig(width=args.width, height=args.height, scene="default",
                       accel="auto", max_depth=6, progressive=True)
    app = Application(cfg)
    rl = app.setup_default_layers()

    frames = []
    radius, cy = 12.0, 2.0
    for i in range(args.frames):
        ang = 2 * math.pi * i / args.frames
        rl.fly.position = [radius * math.sin(ang), cy, radius * math.cos(ang)]
        rl.fly.yaw = 270.0 + math.degrees(ang)
        rl.fly._update_orientation()
        rl.fly.version += 1  # camera moved -> accumulation resets
        app.run(max_frames=args.spp)  # accumulate spp samples at this pose
        frames.append(Image.fromarray(rl.framebuffer_rgba8(), "RGBA").convert("P"))
        print(f"frame {i + 1}/{args.frames} ({rl.metrics.ms_per_frame:.0f} ms/sample)")

    out = os.path.join(os.path.dirname(__file__), "gallery", "orbit.gif")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    frames[0].save(out, save_all=True, append_images=frames[1:], duration=120, loop=0)
    print("wrote", out)
    app.close()


if __name__ == "__main__":
    main()
