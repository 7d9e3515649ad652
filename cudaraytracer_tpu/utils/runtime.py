"""Process set-up shared by the CLI, the benchmark and the smoke check.

Two concerns, both decided once per process before the first compile:

  * the persistent compilation cache — ``JAX_COMPILATION_CACHE_DIR`` wins
    when set (nothing is configured in code then); otherwise the cache
    lives in ``.jax_cache/`` at the root of the checkout.  The path is
    fixed: it is part of the cache's key, so a moving directory never hits.
  * the device — the renderer's production path is the GPU.  A run that
    finds no GPU fails with a message instead of carrying on quietly on
    the CPU; ``--cpu`` (or ``cpu=True``) is the explicit opt-out.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE


class NoGPUError(SystemExit):
    """Exit (status 1, message on stderr) for a GPU run without a GPU."""


def select_backend(cpu: bool = False) -> str:
    """Pin the CPU when ``cpu`` is set; otherwise require a GPU backend.

    Returns ``jax.default_backend()``.  Raises NoGPUError when no GPU is
    present and ``cpu`` was not asked for."""
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
        return jax.default_backend()
    try:
        backend = jax.default_backend()
    except RuntimeError as e:  # a requested platform failed to initialize
        raise NoGPUError(f"no GPU backend: {e}") from None
    if backend != "gpu":
        raise NoGPUError(
            f"no GPU found: JAX backend is {backend!r}. The renderer runs "
            "on an NVIDIA GPU through JAX's CUDA plugin; pass --cpu to run "
            "on the CPU instead.")
    return backend


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name,power.limit``, one line per card); a card below its maximum
    power limit runs slower under load, so every timing is reported
    beside this line.  Returns "" when ``nvidia-smi`` is unavailable."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        return ""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def device_summary() -> dict:
    """Platform, kind and count of JAX's devices (what every result names)."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}
