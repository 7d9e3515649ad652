"""Build the native C++ components.

Usage: python -m cudaraytracer_tpu.native.build

The reference builds its host runtime with CMake/premake (reference:
CMakeLists.txt:1-63, premake5.lua); this framework's native surface is a
single shared library compiled with g++ (no external deps), loaded via
ctypes with a NumPy fallback, so the Python package works without it.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRCS = [os.path.join(HERE, "bvh_builder.cpp")]
LIB = os.path.join(HERE, "libcrt_native.so")


def build(verbose: bool = True) -> str:
    cmd = [
        # -ffp-contract=off: no FMA contraction — NumPy rounds every
        # multiply and subtract separately, and the builder's boxes must
        # match the NumPy builder bit-identically
        "g++", "-O3", "-march=native", "-ffp-contract=off",
        "-shared", "-fPIC", "-std=c++17",
        "-o", LIB, *SRCS,
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    if verbose:
        print(f"built {LIB}")
    return LIB


if __name__ == "__main__":
    sys.exit(0 if build() else 1)
