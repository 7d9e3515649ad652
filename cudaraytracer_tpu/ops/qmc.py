"""Low-discrepancy (QMC) pixel sampling: R2 sequence + per-pixel rotation.

BEYOND-REFERENCE: the CUDA reference draws independent uniform pixel
jitter per sample (curand, Kernel.cu:130-148), so anti-aliasing and all
screen-space integrands converge at the MC rate O(N^-1/2).  This module
replaces the jitter with the R2 additive recurrence (the 2D
generalization of the golden-ratio sequence; Roberts 2018, "The
Unreasonable Effectiveness of Quasirandom Sequences" — public method),
toroidally shifted per pixel by a deterministic rotation field
(Cranley-Patterson rotation via interleaved gradient noise):

    jitter_k(pixel) = frac(rot(pixel) + k * (ALPHA_X, ALPHA_Y))

Per-pixel estimates become QMC quadratures of the smoothed integrand
g(xi) = E[path | jitter xi]: consistent (they converge to the same
limit as the MC estimator) with screen-space error approaching O(N^-1)
on coverage-type integrands instead of O(N^-1/2).  The path decisions
AFTER the primary ray (scatter, lens, Russian roulette, media, NEE
light picks) stay PRNG-driven, so sample estimates remain independent
in the non-jitter dimensions.

The jitter is a pure function of (pixel, global sample index): with QMC
enabled every closest-hit path (brute, BVH with either traversal) traces
IDENTICAL primary rays for the same index, which tests exploit
(tests/test_qmc.py).

The global sample index ``m = sample_base + samples_done_this_launch``
can reach millions in long progressive runs, where frac(m * alpha) in
f32 is garbage (f32 spacing at 1e6 is 0.0625).  ``r2_frac`` therefore
splits m = 4096*mh + ml and uses frac(4096*alpha) precomputed in f64:
frac(m*a) = frac(mh*frac(4096*a) + ml*a), keeping every product under
~4096 where f32 still has ~2^-12 absolute precision — jitter error
stays below ~1e-3 of a pixel out to m = 2^24.
"""

from __future__ import annotations

import numpy as np

# R2 plastic constants: 1/phi2 and 1/phi2^2 with phi2 the plastic number
# (real root of x^3 = x + 1) — the 2D low-discrepancy recurrence.
_PHI2 = 1.3247179572447458
ALPHA_X = 1.0 / _PHI2  # 0.7548776662466927
ALPHA_Y = 1.0 / (_PHI2 * _PHI2)  # 0.5698402909980532

# frac(4096 * alpha) in f64, for the split-precision index trick
C1_X = float(np.mod(4096.0 * ALPHA_X, 1.0))
C1_Y = float(np.mod(4096.0 * ALPHA_Y, 1.0))

# interleaved gradient noise constants (Jimenez 2014, public) — the
# deterministic per-pixel rotation field.  Pure mul/add/floor f32 math.
_IGN_A = 52.9829189
_IGN_BX = 0.06711056
_IGN_BY = 0.00583715
_IGN_SHIFT = 0.41421356  # decorrelates the y-rotation channel


def _frac(x):
    import jax.numpy as jnp

    return x - jnp.floor(x)


def pixel_rotation(xs, ys):
    """Deterministic per-pixel rotation pair (rot_x, rot_y) in [0,1).

    ``xs``/``ys`` are GLOBAL pixel coordinates as f32 arrays (any shape).
    Same values in both render paths — plain f32 mul/add/floor only.
    """
    r1 = _frac(_IGN_A * _frac(_IGN_BX * xs + _IGN_BY * ys))
    r2 = _frac(_IGN_A * _frac(_IGN_BX * (xs + _IGN_SHIFT * 17.0)
                              + _IGN_BY * (ys + _IGN_SHIFT * 29.0))
               + _IGN_SHIFT)
    return r1, r2


def r2_frac(m):
    """(frac(m*ALPHA_X), frac(m*ALPHA_Y)) for an int32 global sample index
    ``m`` (scalar or array, traced ok), split-precision safe to m = 2^24."""
    import jax.numpy as jnp
    from jax import lax

    m = jnp.asarray(m, jnp.int32) if not hasattr(m, "astype") else m.astype(jnp.int32)
    mh = lax.shift_right_logical(m, 12).astype(jnp.float32)
    ml = (m & 4095).astype(jnp.float32)
    fx = _frac(mh * np.float32(C1_X) + ml * np.float32(ALPHA_X))
    fy = _frac(mh * np.float32(C1_Y) + ml * np.float32(ALPHA_Y))
    return fx, fy


def qmc_jitter(xs, ys, m):
    """The full per-pixel QMC jitter pair for global sample index ``m``:
    frac(rotation(pixel) + frac(m * alpha))."""
    rx, ry = pixel_rotation(xs, ys)
    fx, fy = r2_frac(m)
    return _frac(rx + fx), _frac(ry + fy)


def r2_frac_np(m: int):
    """Host/NumPy f64 reference of r2_frac (tests + offline callers)."""
    return (float(np.mod(m * ALPHA_X, 1.0)), float(np.mod(m * ALPHA_Y, 1.0)))
