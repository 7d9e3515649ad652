"""Configuration / flag layer.

The reference has NO config system — every knob is a compile-time constant
mutated via ImGui (SURVEY.md §5; reference: CudaRayTracer/src/Cuda/
CudaLayer.h:66-67,123-127,143-144; Core/Window.h:15).  This dataclass + CLI
layer is the designed-from-scratch replacement; defaults reproduce the
reference's constants (36 spp, depth 12, seed 1984, 1280x720 window).
"""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 36  # reference m_SamplesPerPixel (CudaLayer.h:123)
    max_depth: int = 12  # reference m_MaxDepth (CudaLayer.h:124)
    seed: int = 1984  # reference curand seed (Kernel.cu:163,175)
    t_min: float = 0.001  # reference radiance loop t_min (Kernel.cu:40)
    scene: str = "default"  # default | rtow_final | cornell
    camera_model: str = "two_plane"  # two_plane (reference parity) | look_at
    accel: str = "auto"  # auto | brute | bvh
    #   auto = bvh: the skip-link BVH, traversed by the closest-hit kernel
    #   (ops/bvh_kernel.py) on a GPU and by XLA on the CPU; brute = the
    #   plain all-primitives reference (ops/intersect.py)
    block: int = 64  # primitives per intersection block (brute force)
    aperture: float = 0.0  # defocus-blur lens diameter (look_at camera)
    focus_dist: float = 10.0
    progressive: bool = True  # progressive accumulation vs full-spp re-render
    denoise: bool = False  # display-time SVGF-lite denoiser (a-trous
    #                         wavelet with G-buffer edge-stopping,
    #                         ops/denoise.py) — beyond-reference; applied
    #                         at DISPLAY/export time only, never touches
    #                         the accumulator
    denoise_iters: int = 4  # a-trous iterations (filter radius 2^i px)
    nee: bool = False  # importance-sampled light transport (RTOW book-3
    #                    mixture PDFs, ops/sampling.py) on the XLA accel
    #                    paths (brute/bvh) — beyond-reference; a DIFFERENT
    #                    (true-lambertian) estimator than the reference
    #                    parity default, so opt-in.  Measured ~7x lower
    #                    block error at 16 spp on a small-light Cornell.
    nee_p: float = 0.5  # mixture weight toward light sampling
    qmc: bool = False  # low-discrepancy pixel sampling (R2 sequence +
    #                    per-pixel rotation, ops/qmc.py) — beyond-reference;
    #                    screen-space error approaches O(1/N) instead of the
    #                    reference's O(1/sqrt(N)) curand jitter.  Opt-in: a
    #                    DIFFERENT (deterministic-jitter) sampler than parity.
    debug_nans: bool = False  # analog of the reference Debug build -g -G


def add_arguments(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = RenderConfig()
    parser.add_argument("--width", type=int, default=d.width)
    parser.add_argument("--height", type=int, default=d.height)
    parser.add_argument("--spp", type=int, default=d.spp)
    parser.add_argument("--max-depth", dest="max_depth", type=int, default=d.max_depth)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--t-min", dest="t_min", type=float, default=d.t_min)
    # choices come from the registry so new scenes are CLI-visible
    # automatically (import deferred: config must not pull jax at import)
    from .models.scenes import SCENES as _SCENES

    parser.add_argument("--scene", choices=list(_SCENES), default=d.scene)
    # default None = resolve from the scene registry in from_args (each
    # registered camera was authored for one projection model)
    parser.add_argument("--camera-model", dest="camera_model", choices=["two_plane", "look_at"], default=None)
    parser.add_argument("--accel", choices=["auto", "brute", "bvh"], default=d.accel)
    parser.add_argument("--block", type=int, default=d.block)
    parser.add_argument("--aperture", type=float, default=d.aperture)
    parser.add_argument("--focus-dist", dest="focus_dist", type=float, default=d.focus_dist)
    parser.add_argument("--denoise", action="store_true", default=d.denoise)
    parser.add_argument("--denoise-iters", dest="denoise_iters", type=int, default=d.denoise_iters)
    parser.add_argument("--nee", action="store_true", default=d.nee)
    parser.add_argument("--nee-p", dest="nee_p", type=float, default=d.nee_p)
    parser.add_argument("--qmc", action="store_true", default=d.qmc)
    parser.add_argument("--no-progressive", dest="progressive", action="store_false", default=d.progressive)
    parser.add_argument("--debug-nans", dest="debug_nans", action="store_true", default=d.debug_nans)
    return parser


def from_args(args: argparse.Namespace) -> RenderConfig:
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if kw.get("camera_model") is None:
        from .models.scenes import camera_model_for

        kw["camera_model"] = camera_model_for(kw.get("scene", RenderConfig.scene))
    return RenderConfig(**kw)


def apply_debug_flags(cfg: RenderConfig):
    """Debug-build analog (reference RT_DEBUG + cuda -g -G)."""
    if cfg.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
