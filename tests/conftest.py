"""Test config: run everything on the CPU with 8 virtual devices.

Pallas kernels run through the interpreter on the CPU; multi-device
sharding tests use the 8 virtual host devices.  Must configure before any
backend initializes.  The compiled kernel is checked on the GPU by
chip_smoke.py.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent XLA compilation cache: the fast tier's cost is dominated by
# recompiling the same small jits every run.  JAX_COMPILATION_CACHE_DIR
# wins when set; otherwise .pytest_jax_cache at the repo root.  Safe for
# correctness (keyed on HLO); delete the directory to force cold compiles.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     ".pytest_jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Make the BVH path's default closest hit the GPU kernel run through
    the Pallas interpreter (the CPU's default is the XLA traversal), for
    code that picks its traversal itself (Renderer, the viewer).  Returns
    the traversals resolved while it is active."""
    from cudaraytracer_tpu.models import bvh

    resolve, seen = bvh.resolve_traversal, []

    def interpret(traversal=None):
        seen.append(resolve(traversal or "interpret"))
        return seen[-1]

    monkeypatch.setattr(bvh, "resolve_traversal", interpret)
    return seen
