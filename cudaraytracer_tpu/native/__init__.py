"""Native (C++) runtime components.

The reference's host runtime is C++ (scene slab management, thrust-based
BVH construction, stb image loading).  This framework keeps its hot host
path native too: ``bvh_native`` is a C++ binned-SAH BVH builder exposed via
ctypes (built with ``python -m cudaraytracer_tpu.native.build``), with a
NumPy fallback in models/bvh.py when the shared library is absent.
"""
