"""Edge-avoiding a-trous wavelet denoiser (SVGF-lite).

Beyond-reference subsystem: the CUDA reference ships no denoiser — its
only noise control is brute spp (Kernel.cu:137-148).  This module
implements the edge-avoiding a-trous wavelet transform (Dammertz et al.
2010) with SVGF-style feature weights (Schied et al. 2017): each
iteration convolves the radiance image with a 5x5 B3-spline kernel whose
taps are spaced 2^i pixels apart, and every tap is modulated by
edge-stopping weights from the G-buffer (normal/albedo/depth,
ops/gbuffer.py) and from luminance (optionally scaled by a per-pixel
variance plane when the caller has one).

The whole filter is static-shaped XLA — 25 edge-padded static slices per
iteration, elementwise weight math fused by XLA; no gathers, no
data-dependent control flow, jit-cached per (H, W, iterations).  A 720p
4-iteration pass is ~100 fused elementwise ops over [720,1280] planes,
applied only at DISPLAY time (not per accumulation frame).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .gbuffer import GBuffer

# 5x5 B3-spline weights (outer product of [1,4,6,4,1]/16)
_H1D = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)

_LUM = (0.2126, 0.7152, 0.0722)


def _luminance(c: jnp.ndarray) -> jnp.ndarray:
    return c[..., 0] * _LUM[0] + c[..., 1] * _LUM[1] + c[..., 2] * _LUM[2]


def atrous_denoise(
    color: jnp.ndarray,  # f32[H,W,3] mean radiance (linear, pre-gamma)
    gb: GBuffer,
    variance: jnp.ndarray | None = None,  # f32[H,W] per-pixel luminance var
    *,
    iterations: int = 4,
    sigma_normal: float = 32.0,  # power on the normal dot (SVGF sigma_n)
    sigma_depth: float = 0.10,  # relative depth falloff
    sigma_albedo: float = 0.15,  # L2 albedo falloff
    sigma_lum: float = 0.30,  # luminance falloff (x sqrt(var) when given)
) -> jnp.ndarray:
    """Denoised radiance, same shape/scale as ``color``.

    Edge-stopping weights per tap q against center p:
      w_n = max(0, n_p . n_q)^sigma_normal          (0 on the sky: n = 0)
      w_z = exp(-|z_p - z_q| / (sigma_depth * max(z_p, z_q) + eps))
      w_a = exp(-||a_p - a_q||^2 / sigma_albedo^2)
      w_l = exp(-|l_p - l_q| / (sigma_lum * sqrt(var_p) + eps))  [variance]
          = exp(-|l_p - l_q|^2 / sigma_lum^2)                    [without]
    The sky (normal = 0, depth = 0) forms its own region: w_n = 0 against
    any surface, and two sky pixels agree on depth/albedo, so the gradient
    background is smoothed without bleeding into silhouettes.
    """
    h, w = color.shape[:2]
    lum = _luminance(color)
    eps = 1e-6

    def taps(img, s):
        """Edge-replicated 5x5 taps at spacing s: list of [H,W,...]"""
        p = 2 * s
        cfg = [(0, 0)] * (img.ndim - 2)
        padded = jnp.pad(img, [(p, p), (p, p)] + cfg, mode="edge")
        out = []
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                out.append(
                    jax.lax.slice(
                        padded,
                        (p + dy * s, p + dx * s) + (0,) * (img.ndim - 2),
                        (p + dy * s + h, p + dx * s + w) + img.shape[2:],
                    )
                )
        return out

    # luminance scale: with a variance plane the threshold adapts per
    # pixel (noisy pixels accept more smoothing), SVGF eq. (2)
    if variance is not None:
        lscale = sigma_lum * jnp.sqrt(jnp.maximum(variance, 0.0)) + eps
    else:
        lscale = None

    out = color
    for it in range(iterations):
        s = 1 << it
        c_taps = taps(out, s)
        n_taps = taps(gb.normal, s)
        a_taps = taps(gb.albedo, s)
        z_taps = taps(gb.depth, s)
        l_taps = taps(_luminance(out), s)

        wsum = jnp.zeros((h, w), jnp.float32)
        csum = jnp.zeros((h, w, 3), jnp.float32)
        k = 0
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                hk = _H1D[dy + 2] * _H1D[dx + 2]
                ndot = jnp.maximum(
                    jnp.sum(gb.normal * n_taps[k], axis=-1), 0.0)
                # sky pixels (n = 0) match each other via the 0^0 := 1
                # convention; against a surface ndot = 0 -> weight 0
                both_sky = (jnp.sum(jnp.abs(gb.normal), axis=-1) < eps) & (
                    jnp.sum(jnp.abs(n_taps[k]), axis=-1) < eps)
                w_n = jnp.where(both_sky, 1.0, ndot ** sigma_normal)
                zq = z_taps[k]
                w_z = jnp.exp(
                    -jnp.abs(gb.depth - zq)
                    / (sigma_depth * jnp.maximum(gb.depth, zq) + eps))
                da = gb.albedo - a_taps[k]
                w_a = jnp.exp(-jnp.sum(da * da, axis=-1)
                              / (sigma_albedo * sigma_albedo))
                dl = jnp.abs(lum - l_taps[k])
                if lscale is not None:
                    w_l = jnp.exp(-dl / lscale)
                else:
                    w_l = jnp.exp(-(dl * dl) / (sigma_lum * sigma_lum))
                wgt = hk * w_n * w_z * w_a * w_l
                wsum = wsum + wgt
                csum = csum + wgt[..., None] * c_taps[k]
                k += 1
        out = csum / jnp.maximum(wsum, eps)[..., None]
        # luminance edge threshold follows the smoothed image (the a-trous
        # recursion filters the DETAIL layers; lum is re-derived per pass)
        lum = _luminance(out)
    return out


@functools.lru_cache(maxsize=8)
def denoise_step(height: int, width: int, iterations: int = 4):
    """Jitted (color, normal, albedo, depth, variance?) -> denoised color,
    cached per static shape (the viewer calls this at display rate)."""

    @jax.jit
    def _run(color, normal, albedo, depth, variance=None):
        gb = GBuffer(normal=normal, albedo=albedo, depth=depth)
        return atrous_denoise(color, gb, variance, iterations=iterations)

    return _run
