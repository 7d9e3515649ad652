from . import bvh, camera, renderer, scene, scenes

__all__ = ["bvh", "camera", "renderer", "scene", "scenes"]
