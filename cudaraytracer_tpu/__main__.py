"""CLI entry: render offline, serve the interactive viewer, or bench.

The reference's entry is Main.cpp:5-15 (init log, construct Application,
run).  This adds the config/flag layer the reference lacks (SURVEY.md §5).

  python -m cudaraytracer_tpu render --scene rtow_final -o out.png
  python -m cudaraytracer_tpu serve --port 8000
  python -m cudaraytracer_tpu bench
"""

from __future__ import annotations

import argparse
import sys
import time

from . import config as config_mod
from .utils import logging as rtlog


def cmd_render(cfg, args):
    import jax

    from .utils.image import save_png
    from .viewer.app import Application

    app = Application(cfg)
    rl = app.setup_default_layers()
    rtlog.rt_info("Rendering %d frame(s) of %d spp on %s ...",
                  args.frames, 1 if cfg.progressive else cfg.spp, jax.default_backend())
    # the first frame compiles; time the rest (each frame ends on the
    # device: RenderLayer.on_update blocks until its accumulator is ready)
    t0 = time.perf_counter()
    app.run(max_frames=1)
    first_s = time.perf_counter() - t0
    ms = None
    if args.frames > 1:
        t0 = time.perf_counter()
        app.run(max_frames=args.frames - 1)
        ms = (time.perf_counter() - t0) / (args.frames - 1) * 1000
    if app.frame_failures:
        raise SystemExit(f"render: {app.frame_failures} frame(s) failed "
                         "(see the log above)")
    rtlog.rt_info("Done: first frame %.2f s (compile included)%s; "
                  "accumulated %d spp", first_s,
                  "" if ms is None else f", then {ms:.2f} ms/frame",
                  rl._spp_done)
    if args.output.lower().endswith((".pfm", ".npy")):
        # HDR export: linear mean radiance, no gamma/clamp
        from .utils.image import save_pfm

        rad = rl.radiance_mean()
        if args.output.lower().endswith(".npy"):
            import numpy as np

            np.save(args.output, rad)
        else:
            save_pfm(args.output, rad)
    else:
        save_png(args.output, rl.framebuffer_rgba8(), flip_vertical=False)
    rtlog.rt_info("Wrote %s", args.output)
    if getattr(args, "aov", None):
        _write_aov(rl, args.aov)
    app.close()
    return {"frames": args.frames, "first_frame_s": first_s,
            "ms_per_frame": ms, "spp": rl._spp_done}


def _write_aov(rl, path: str):
    """Export the G-buffer AOVs: .npz = raw f32 arrays; any other path is
    a prefix for three PNG visualizations (normal mapped 0.5n+0.5, albedo
    gamma-2 like the display, depth normalized to its max)."""
    import numpy as np

    aov = rl.aov()
    if path.lower().endswith(".npz"):
        np.savez(path, **aov)
        rtlog.rt_info("Wrote %s (normal/albedo/depth f32 arrays)", path)
        return
    from .utils.image import save_png as _save

    def u8(x):
        return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

    vis = {
        "normal": u8(aov["normal"] * 0.5 + 0.5),
        "albedo": u8(np.sqrt(np.clip(aov["albedo"], 0.0, 1.0))),
        # robust scale: a ground plane's horizon t is enormous and a max
        # normalization would crush everything else to black
        "depth": u8(aov["depth"] / max(
            float(np.percentile(aov["depth"][aov["depth"] > 0], 95.0))
            if (aov["depth"] > 0).any() else 1.0, 1e-6)),
    }
    for name, img in vis.items():
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        out = f"{path}_{name}.png"
        _save(out, img, flip_vertical=False)
        rtlog.rt_info("Wrote %s", out)


def cmd_serve(cfg, args):
    from .viewer.app import Application
    from .viewer.server import ViewerServer

    app = Application(cfg)
    app.setup_default_layers()
    server = ViewerServer(app, host=args.host, port=args.port,
                          data_dir=args.data_dir)
    server.start()
    try:
        app.run()  # progressive forever; browser drives edits/camera
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        app.close()


def cmd_bench(cfg, args):
    import os
    import runpy

    sys.argv = ["bench.py"] + (["--cpu"] if args.cpu else [])
    runpy.run_path(os.path.join(os.path.dirname(__file__), "..", "bench.py"),
                   run_name="__main__")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cudaraytracer_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_obj_args(p):
        p.add_argument("--obj", default=None, metavar="PATH",
                       help="render a Wavefront OBJ model: loads it, "
                            "normalizes it onto the checkered ground and "
                            "registers it as the active scene (overrides "
                            "--scene); per-vertex uvs/normals are kept")
        p.add_argument("--obj-mat", dest="obj_mat", default="lambertian",
                       choices=["lambertian", "metal", "dielectric", "light"])
        p.add_argument("--obj-albedo", dest="obj_albedo", default="0.75,0.73,0.70",
                       metavar="R,G,B")
        p.add_argument("--obj-fuzz", dest="obj_fuzz", type=float, default=0.0)
        p.add_argument("--obj-ior", dest="obj_ior", type=float, default=1.5)
        p.add_argument("--obj-smooth", dest="obj_smooth", action="store_true",
                       help="compute smooth vertex normals when the file "
                            "has none")

    p_render = sub.add_parser("render", help="offline render to PNG")
    config_mod.add_arguments(p_render)
    add_obj_args(p_render)
    p_render.add_argument("-o", "--output", default="render.png")
    p_render.add_argument("--aov", default=None, metavar="PATH",
                          help="also export the first-hit feature buffers "
                               "(G-buffer AOVs: normal/albedo/depth). A "
                               ".npz path writes the raw f32 arrays; any "
                               "other path is a prefix for three PNG "
                               "visualizations (<p>_normal/_albedo/"
                               "_depth.png)")
    p_render.add_argument("--frames", type=int, default=None,
                          help="progressive frames (default: spp)")
    p_render.add_argument("--cpu", action="store_true",
                          help="run on the CPU (default: require a GPU)")

    p_serve = sub.add_parser("serve", help="interactive viewer")
    config_mod.add_arguments(p_serve)
    add_obj_args(p_serve)
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--data-dir", dest="data_dir", default=None,
                         help="directory scene saves/loads and checkpoints "
                              "are confined to (default: cwd)")
    p_serve.add_argument("--cpu", action="store_true",
                         help="run on the CPU (default: require a GPU)")

    p_bench = sub.add_parser("bench", help="run the headline benchmark")
    p_bench.add_argument("--cpu", action="store_true",
                         help="run on the CPU (default: require a GPU)")

    args = parser.parse_args(argv)
    from .utils.runtime import enable_compile_cache, select_backend

    select_backend(cpu=args.cpu)
    enable_compile_cache()

    rtlog.init()
    if args.cmd == "bench":
        return cmd_bench(None, args)
    if getattr(args, "obj", None):
        from .models import scene as scene_mod
        from .models import scenes as scene_lib

        mat = {"lambertian": scene_mod.LAMBERTIAN, "metal": scene_mod.METAL,
               "dielectric": scene_mod.DIELECTRIC,
               "light": scene_mod.DIFFUSE_LIGHT}[args.obj_mat]
        albedo = tuple(float(x) for x in args.obj_albedo.split(","))
        args.scene = scene_lib.register_obj_scene(
            args.obj, mat_type=mat, albedo=albedo, fuzz=args.obj_fuzz,
            ior=args.obj_ior, smooth=args.obj_smooth)
        # camera_model stays as parsed: None resolves to the registry's
        # look_at; an explicit --camera-model still wins
        rtlog.rt_info("Registered OBJ scene %r from %s", args.scene, args.obj)
    cfg = config_mod.from_args(args)
    config_mod.apply_debug_flags(cfg)
    if args.cmd == "render":
        if args.frames is None:
            args.frames = cfg.spp if cfg.progressive else 1
        return cmd_render(cfg, args)
    if args.cmd == "serve":
        return cmd_serve(cfg, args)


if __name__ == "__main__":
    main()
