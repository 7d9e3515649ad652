"""Noise/marble texture (ops/noise.py + tex_type 3, BEYOND-REFERENCE).

The reference's texture set stops at Constant/Checker/Image
(Texture.cuh:7-109); this framework adds the RTOW "The Next Week"
value-noise marble as a fourth type, wired through every path: the XLA
sampler (ops/textures.py) and the NumPy oracle.  tex_id is REPURPOSED as
the integer marble scale.

Cross-backend agreement is ~5e-3, not bit-exact (the 43758 hash amplifies
the sin backend's ulp error — noise.py "Numerical note"); the mod-61
lattice wrap makes that bound hold at ANY scene coordinate.
"""

import numpy as np

from cudaraytracer_tpu.ops import noise


# ----------------------------------------------------------------- module
def test_noise_cross_backend_tolerance_any_coordinate():
    """numpy vs jax.numpy agree STATISTICALLY to the documented ~5e-3 —
    including at coordinates ~1e3 from the origin and after 6 octave
    doublings, where the unwrapped hash lost all agreement.

    The bound is a quantile, not a sup: fract is discontinuous, so a
    1-ulp sin difference can flip a lattice corner's hash by ~1 when
    sin*43758 lands within ~4e-3 of an integer (probability ~0.4% per
    corner draw) — rare isolated cells, never a systematic drift."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    for scale in (1.0, 1000.0):  # near the origin AND far away
        p = (rng.uniform(-4, 4, (3, 256)) * scale).astype(np.float32)
        n_np = noise.value_noise(p[0], p[1], p[2], xp=np)
        n_jx = np.asarray(noise.value_noise(
            jnp.asarray(p[0]), jnp.asarray(p[1]), jnp.asarray(p[2]), xp=jnp))
        d = np.abs(n_np - n_jx)
        assert np.percentile(d, 99) < 5e-3, scale
        assert (d > 5e-3).mean() < 0.02, scale
        t_np = noise.turbulence(p[0], p[1], p[2], xp=np)
        t_jx = np.asarray(noise.turbulence(
            jnp.asarray(p[0]), jnp.asarray(p[1]), jnp.asarray(p[2]), xp=jnp))
        # octaves sum 7 draws (weights 1 + 1/2 + ... = 2): ~2x one draw,
        # and 56 corner draws per point multiply the flip odds (~20%)
        d = np.abs(t_np - t_jx)
        assert np.percentile(d, 75) < 2e-2, scale
        assert np.median(d) < 1e-2, scale


def test_noise_statistics_and_continuity():
    """Value noise is a real noise function: full [0,1) swing, ~uniform
    mean, C0-continuous (the smoothstep fade zeroes corner hash jumps),
    and NOT constant inside a cell."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-50, 50, (3, 4096)).astype(np.float32)
    n = noise.value_noise(p[0], p[1], p[2], xp=np)
    assert n.min() >= 0.0 and n.max() <= 1.0
    assert 0.35 < n.mean() < 0.65
    assert n.std() > 0.1
    # continuity: an eps step moves the value by O(eps * max-slope)
    eps = np.float32(1e-3)
    n2 = noise.value_noise(p[0] + eps, p[1], p[2], xp=np)
    assert np.abs(n2 - n).max() < 0.02
    # marble factor bounded
    m = noise.marble_factor(p[0], p[1], p[2], 4.0, xp=np)
    assert m.min() >= 0.0 and m.max() <= 1.0 and m.std() > 0.05


def test_noise_wrap_period_exact():
    """The mod-61 lattice wrap tiles the HASH with period 61 per axis,
    EXACTLY (integer lattice coords make the wrap exact f32 arithmetic) —
    this is what bounds the sin argument at any coordinate.  The noise
    itself is periodic up to the f32 rounding of the shifted FRACTIONAL
    coordinate (p + 61 quantizes p's fraction to ulp(61) ~ 7.6e-6)."""
    rng = np.random.default_rng(5)
    cell = rng.integers(-1000, 1000, (3, 512)).astype(np.float32)
    a = noise.lattice_hash(cell[0], cell[1], cell[2], xp=np)
    b = noise.lattice_hash(cell[0] + np.float32(61.0), cell[1], cell[2],
                           xp=np)
    np.testing.assert_array_equal(a, b)
    p = rng.uniform(0, 10, (3, 512)).astype(np.float32)
    na = noise.value_noise(p[0], p[1], p[2], xp=np)
    nb = noise.value_noise(p[0] + np.float32(61.0), p[1], p[2], xp=np)
    np.testing.assert_allclose(na, nb, atol=1e-4)


# ----------------------------------------------------------------- sampler
def test_sample_texture_noise_branch():
    """tex_type 3 returns lerp(albedo2, albedo, marble_factor(p, tex_id))
    and leaves the other types untouched."""
    import jax.numpy as jnp

    from cudaraytracer_tpu.ops import textures

    rng = np.random.default_rng(7)
    R = 128
    p = jnp.asarray(rng.uniform(-5, 5, (R, 3)).astype(np.float32))
    albedo = jnp.asarray(rng.uniform(0, 1, (R, 3)).astype(np.float32))
    albedo2 = jnp.asarray(rng.uniform(0, 1, (R, 3)).astype(np.float32))
    tex_type = jnp.asarray(np.r_[np.zeros(64), np.full(64, 3)].astype(np.int32))
    tex_id = jnp.asarray(np.full(R, 4, np.int32))  # marble scale 4
    u = v = jnp.zeros(R)
    atlas = jnp.zeros((1, 4, 4, 3), jnp.uint8)
    tex_hw = jnp.zeros((1, 2), jnp.int32)
    out = np.asarray(textures.sample_texture(
        tex_type, albedo, albedo2, tex_id, u, v, p, atlas, tex_hw))
    np.testing.assert_array_equal(out[:64], np.asarray(albedo)[:64])
    fac = noise.marble_factor(np.asarray(p[64:, 0]), np.asarray(p[64:, 1]),
                              np.asarray(p[64:, 2]), np.float32(4.0), xp=np)
    want = (np.asarray(albedo2)[64:]
            + fac[:, None] * (np.asarray(albedo)[64:] - np.asarray(albedo2)[64:]))
    # statistical bound (noise.py "Numerical note"): rare fract flips in
    # the numpy-vs-XLA cross-check shift isolated lattice cells outright
    d = np.abs(out[64:] - want)
    assert np.median(d) < 2e-3 and (d > 6e-3).mean() < 0.05, (
        np.median(d), (d > 6e-3).mean())


# ----------------------------------------------------------------- renders
def test_marble_scene_matches_oracle():
    """The marble scene through the XLA renderer vs the scalar oracle
    (block means, the standard golden contract)."""
    import oracle

    from cudaraytracer_tpu.models import scenes
    from cudaraytracer_tpu.models.renderer import render_radiance
    from cudaraytracer_tpu.utils import rng as rngu

    W, H, SPP, DEPTH = 24, 16, 12, 5
    sc = scenes.marble_scene()
    cam = scenes.marble_camera()
    origin = tuple(float(v) for v in np.asarray(cam.origin))
    fwd = tuple(float(v) for v in np.asarray(cam.forward))
    gold = oracle.render_look_at(sc, origin, fwd, W, H, SPP, DEPTH,
                                 seed=5, fov_deg=40.0)
    ours = np.asarray(
        render_radiance(sc.device(), cam, rngu.base_key(), SPP * 2, DEPTH,
                        width=W, height=H, camera_model="look_at")
    ) / (SPP * 2)
    np.testing.assert_allclose(ours.mean((0, 1)), gold.mean((0, 1)), atol=0.05)
    blk_g = gold.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    blk_o = ours.reshape(H // 4, 4, W // 4, 4, 3).mean((1, 3))
    err = np.abs(blk_g - blk_o)
    assert err.mean() < 0.05, f"mean block error {err.mean()}"

