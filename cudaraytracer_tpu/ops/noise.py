"""Procedural value-noise / marble texture math (BEYOND-REFERENCE).

The reference's texture set stops at Constant/Checker/Image
(CudaRayTracer/src/Hittables/Texture.cuh:7-109); this adds the classic
"Ray Tracing: The Next Week" noise/marble texture as a fourth type.

The canonical Perlin implementation keeps permutation TABLES and gathers
them per-lattice-point.  Here the lattice hash is TABLE-FREE instead: a
float hash (fract(sin(dot(cell, K)) * 43758.5453), the standard GLSL
shader-land hash) built only from mul/add/sin/floor — elementwise ops
that fuse and vectorize identically in XLA and NumPy.

Every function takes an ``xp`` module (numpy or jax.numpy) so ONE
implementation serves the XLA renderers and the NumPy test oracle.
Inputs are component arrays (px, py, pz).

Numerical note: the hash AMPLIFIES ulp differences (the 43758.5453 factor
multiplies the sin backend's rounding error before fract), so outputs agree
across backends only to ~5e-3, not bit-exactly — cross-backend tests
compare with that tolerance (tests/test_noise.py).  Within one backend the
noise is deterministic and C0-continuous in p (corner hash discontinuities
are zero-weighted by the smoothstep fade).  The agreement is STATISTICAL,
not a sup bound: fract is discontinuous, so when sin*43758 lands within
~4e-3 of an integer a 1-ulp sin difference flips that corner's hash by ~1
(~0.4% of corner draws) — isolated cells differ outright, the quantiles
hold (tests/test_noise.py).

Range note: lattice coords are WRAPPED mod 61 before hashing,
bounding |sin argument| < ~3.2e4 at ANY scene coordinate and octave count —
without the wrap, f32 ulp error times the 43758 amplification exceeds 1
once ~516*||p||*2^octave grows past ~1e7, and the ~5e-3 cross-backend
agreement (and a fast sin's usable range) would only hold near the origin.
The noise therefore tiles with period 61 lattice cells per axis (61^3
distinct cells) — invisible at texture scales, and the wrap is exact in
f32 (lattice coords are integers far below 2^24).
"""

from __future__ import annotations

import numpy as np

# Lattice hash constants (shader-land convention).
_KX, _KY, _KZ = 127.1, 311.7, 74.7
_AMP = 43758.5453
_PERIOD = 61.0  # lattice wrap period (module docstring "Range note")

#: Octaves in the turbulence sum (RTOW "The Next Week" default depth 7).
TURB_OCTAVES = 7


def _wrap(x, xp):
    """x mod 61, exact in f32 for integer lattice coords (|x| < 2^24).

    TRUE division, not multiply-by-reciprocal: x * (1/61.) rounds just
    below k at multiples of 61 (61 * fl(1/61) = 0.99999994), making
    wrap(61) = 61 != wrap(0) and breaking the tiling; x / 61 is correctly
    rounded, and for integer x = 61k + m the quotient k + m/61 is always
    > ulp away from an integer, so floor is exact."""
    return x - xp.floor(x / _PERIOD) * _PERIOD


def lattice_hash(ix, iy, iz, xp=np):
    """Pseudo-random value in [0, 1) per integer lattice cell (float coords).

    Coords wrap mod 61 first so the sin argument stays small at any scene
    coordinate (docstring "Range note"); cells sharing a corner see the
    same wrapped value, so continuity across cell faces is preserved."""
    s = xp.sin(_wrap(ix, xp) * _KX + _wrap(iy, xp) * _KY
               + _wrap(iz, xp) * _KZ) * _AMP
    return s - xp.floor(s)


def value_noise(px, py, pz, xp=np):
    """Trilinearly-interpolated value noise in [0, 1), smoothstep-faded.

    The analog of RTOW's trilinear-interp Perlin (the value-noise variant:
    random scalars at lattice corners rather than gradients — table-free,
    see module docstring)."""
    ix, iy, iz = xp.floor(px), xp.floor(py), xp.floor(pz)
    fx, fy, fz = px - ix, py - iy, pz - iz
    # Hermite fade: zero derivative at the corners, so the corner hash
    # discontinuities never show (C1 inside cells, C0 across them).
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    uz = fz * fz * (3.0 - 2.0 * fz)

    def h(dx, dy, dz):
        return lattice_hash(ix + dx, iy + dy, iz + dz, xp)

    c00 = h(0.0, 0.0, 0.0) + ux * (h(1.0, 0.0, 0.0) - h(0.0, 0.0, 0.0))
    c10 = h(0.0, 1.0, 0.0) + ux * (h(1.0, 1.0, 0.0) - h(0.0, 1.0, 0.0))
    c01 = h(0.0, 0.0, 1.0) + ux * (h(1.0, 0.0, 1.0) - h(0.0, 0.0, 1.0))
    c11 = h(0.0, 1.0, 1.0) + ux * (h(1.0, 1.0, 1.0) - h(0.0, 1.0, 1.0))
    c0 = c00 + uy * (c10 - c00)
    c1 = c01 + uy * (c11 - c01)
    return c0 + uz * (c1 - c0)


def turbulence(px, py, pz, xp=np, octaves: int = TURB_OCTAVES):
    """|sum of signed noise octaves| — RTOW Perlin::turb semantics
    (halved weight, doubled frequency per octave, absolute value last)."""
    acc = 0.0
    w = 1.0
    x, y, z = px, py, pz
    for _ in range(octaves):
        acc = acc + w * (2.0 * value_noise(x, y, z, xp) - 1.0)
        w = w * 0.5
        x, y, z = x * 2.0, y * 2.0, z * 2.0
    return xp.abs(acc)


def marble_factor(px, py, pz, scale, xp=np):
    """Marble mixing factor in [0, 1]: 0.5*(1 + sin(scale*z + 10*turb(p))).

    RTOW "The Next Week" marble (NoiseTexture::value); the scene's texture
    color is lerp(albedo2, albedo, factor) — set albedo2 to black for the
    book's white marble."""
    return 0.5 * (1.0 + xp.sin(scale * pz + 10.0 * turbulence(px, py, pz, xp)))
