"""Headline benchmark: RTOW final scene, 1280x720, 1 spp progressive.

Times one progressive 1-spp frame (max_depth 12) of the RTOW final scene
(~489 spheres) through the production path — the BVH with the closest-hit
kernel on the GPU — the workload BASELINE.json names.  Each timed frame
ends in ``block_until_ready``; rays are the renderer's own count (primary
plus bounces).  Prints the card's name and power limit, then ONE JSON line.

Fails (non-zero exit) without a GPU.  ``--cpu`` is a rehearsal of the same
code path on the CPU: it prints no device metric.

``--trace DIR`` then records the same number of frames again with
``jax.profiler`` into DIR (the timed frames run with the profiler off)
and adds to the JSON line the device's busy time, its idle share over the
traced span, and the device time of each kernel by name (trace_breakdown).

Usage: python bench.py [--width W --height H --spp N --depth D --frames K]
                       [--scene NAME] [--accel auto|bvh|brute]
                       [--trace DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

TOP_OPS = 15


def trace_breakdown(events):
    """Device time of one traced window from its device events
    ``[(name, start_ns, duration_ns)]``: busy = the union of the events'
    intervals, span = first start to last end, idle share = 1 - busy /
    span, and each name's summed duration, largest first."""
    if not events:
        raise ValueError("no device events in the trace")
    busy, end, per_op = 0, None, {}
    for name, start, dur in sorted(events, key=lambda e: e[1]):
        per_op[name] = per_op.get(name, 0) + dur
        stop = start + dur
        if end is None or start >= end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    span = max(s + d for _, s, d in events) - min(s for _, s, _ in events)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP_OPS]
    return {"device_busy_ms": busy / 1e6, "device_span_ms": span / 1e6,
            "idle_share": 1.0 - busy / span if span else 0.0,
            "ops_ms": [[n, d / 1e6] for n, d in ops]}


def read_trace(trace_dir):
    """``[(name, start_ns, duration_ns)]`` of the kernels and copies on the
    GPU streams of the newest trace under ``trace_dir``."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")),
        key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no profiler trace under {trace_dir}")
    events = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            # the "Stream #N(...)" lines hold what ran; the other lines of
            # a device plane group the same events again
            if line.name.startswith("Stream"):
                events += [(e.name, e.start_ns, e.duration_ns)
                           for e in line.events]
    return events


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--frames", type=int, default=8, help="timed frames")
    p.add_argument("--accel", default="auto", choices=["auto", "bvh", "brute"])
    p.add_argument("--scene", default="rtow_final")
    p.add_argument("--trace", metavar="DIR",
                   help="trace --frames more frames into DIR and add the "
                        "device time breakdown")
    p.add_argument("--cpu", action="store_true",
                   help="rehearse on the CPU (prints no device metric)")
    args = p.parse_args(argv)

    from cudaraytracer_tpu.utils.runtime import (
        device_summary, enable_compile_cache, gpu_name_and_power_limit,
        select_backend)

    select_backend(cpu=args.cpu)
    enable_compile_cache()

    import jax

    from cudaraytracer_tpu.models import scenes
    from cudaraytracer_tpu.models.bvh import (build_bvh, make_bvh_hit_fn,
                                              resolve_traversal)
    from cudaraytracer_tpu.models.renderer import render_radiance
    from cudaraytracer_tpu.utils import rng as rngu

    accel = "bvh" if args.accel == "auto" else args.accel
    make_scene, make_cam = scenes.SCENES[args.scene]
    scene = make_scene()
    sd, cam = scene.device(), make_cam()
    bvh = build_bvh(scene) if accel == "bvh" else None
    camera_model = scenes.camera_model_for(args.scene)

    @jax.jit
    def frame(sd, bvh, cam, key):
        hit_fn = None if bvh is None else make_bvh_hit_fn(bvh, sd)
        return render_radiance(
            sd, cam, key, args.spp, args.depth,
            width=args.width, height=args.height,
            camera_model=camera_model, hit_fn=hit_fn, with_stats=True)

    key = rngu.base_key()
    t0 = time.perf_counter()
    jax.block_until_ready(frame(sd, bvh, cam, key))
    compile_s = time.perf_counter() - t0
    times, rays = [], []
    for f in range(args.frames):
        k = jax.random.fold_in(key, 100 + f)
        t0 = time.perf_counter()
        rad, nrays = frame(sd, bvh, cam, k)
        rad.block_until_ready()
        times.append(time.perf_counter() - t0)
        rays.append(float(nrays))
    order = sorted(range(len(times)), key=times.__getitem__)
    mid = order[len(order) // 2]
    ms = times[mid] * 1e3
    device = device_summary()
    walk = ("" if bvh is None
             else f", {resolve_traversal()} traversal")
    label = (f"{args.scene} {args.width}x{args.height} {args.spp}spp "
             f"depth{args.depth} ({accel}{walk})")
    if args.cpu:
        result = {"rehearsal": "cpu", "workload": label,
                  "frames": args.frames, "device": device}
    else:
        card = gpu_name_and_power_limit()
        print(f"card: {card}")
        result = {
            "metric": f"Mrays/s {label}",
            "value": rays[mid] / (ms * 1e3),
            "unit": "Mrays/s",
            "ms_per_frame": ms,
            "ms_per_frame_min": min(times) * 1e3,
            "rays_per_frame": rays[mid],
            "frames": args.frames,
            "compile_s": compile_s,
            "accel": accel,
            "card": card,
            "device": device,
        }
    if args.trace:
        t0 = time.perf_counter()
        with jax.profiler.trace(args.trace):
            for f in range(args.frames):
                k = jax.random.fold_in(key, 200 + f)
                frame(sd, bvh, cam, k)[0].block_until_ready()
        result["trace"] = {
            "frames": args.frames,
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            **trace_breakdown(read_trace(args.trace))}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
