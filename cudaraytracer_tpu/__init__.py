"""cudaraytracer_tpu — a real-time path-tracing framework for NVIDIA GPUs.

Brand-new JAX/XLA/Pallas re-architecture of the capabilities of the CUDA
reference renderer (Trippasch/CudaRayTracer): an interactive progressive
"Ray Tracing in One Weekend"-family renderer with spheres + axis-aligned
rects, BVH acceleration, lambertian/metal/dielectric/diffuse-light
materials, constant/checker/image textures, gradient sky, fly camera, and
live scene editing — built on SoA scene tensors, counter-based RNG, masked
wavefront bounce loops, a Pallas closest-hit kernel and shard_map
multi-device tiling.

See SURVEY.md at the repo root for the reference structural analysis this
framework is built to.
"""

from .models.camera import CameraParams, FlyCamera, make_camera_params
from .models.renderer import Renderer, render_radiance, trace
from .models.scene import Scene, SceneData

__version__ = "0.3.0"

__all__ = [
    "CameraParams",
    "FlyCamera",
    "make_camera_params",
    "Renderer",
    "render_radiance",
    "trace",
    "Scene",
    "SceneData",
]
