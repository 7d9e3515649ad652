"""Property tests (SURVEY.md §4c): physical invariants on random scenes.

The reference has no tests at all; these pin down the physics that the
statistical golden tests only sample: energy conservation (no path can
amplify radiance without a light) and Snell/Fresnel reciprocity of the
dielectric, on randomized inputs.
"""

import numpy as np
import pytest

from cudaraytracer_tpu.models.camera import make_camera_params
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.models.scene import (
    CHECKER, DIELECTRIC, LAMBERTIAN, METAL, Scene)
from cudaraytracer_tpu.utils import rng as rngu


def _random_lightless_scene(seed, n=12):
    r = np.random.default_rng(seed)
    scene = Scene(capacity=32,
                  background_start=(1.0, 1.0, 1.0),
                  background_end=(0.5, 0.7, 1.0))
    scene.add_xz_rect((0, 0, 0), 60, 60, mat_type=LAMBERTIAN,
                      albedo=(0.8, 0.8, 0.0), tex_type=CHECKER,
                      albedo2=(0.2, 0.3, 0.1))
    for _ in range(n):
        mat = int(r.integers(0, 3))  # no diffuse_light
        kw = dict(mat_type=(LAMBERTIAN, METAL, DIELECTRIC)[mat],
                  albedo=tuple(r.uniform(0.05, 1.0, 3)),
                  fuzz=float(r.uniform(0, 1)),
                  ior=float(r.uniform(1.05, 2.4)))
        scene.add_sphere(tuple(r.uniform(-4, 4, 2)) + (-float(r.uniform(2, 8)),),
                         float(r.uniform(0.2, 1.0)), **kw)
    return scene


@pytest.mark.slow
def test_energy_conservation_lightless_scenes():
    """Without emitters, every albedo <= 1 and sky <= 1, so every sample's
    radiance is a product of factors <= 1 times the sky: no channel may
    exceed the sky maximum (1.0).  Holds per-PIXEL at any spp because the
    mean of bounded samples is bounded (reference color(), Kernel.cu:27-79
    — the loop only ever multiplies attenuations in [0,1])."""
    for seed in (0, 1, 2):
        scene = _random_lightless_scene(seed)
        sd = scene.device()
        cam = make_camera_params(origin=(0.0, 1.5, 6.0),
                                 forward=(0.0, -0.1, -1.0))
        spp = 4
        rad = np.asarray(render_radiance(
            sd, cam, rngu.base_key(), spp, 8, width=48, height=32,
            camera_model="look_at")) / spp
        assert np.isfinite(rad).all()
        assert rad.max() <= 1.0 + 1e-5, f"seed {seed}: max {rad.max()}"
        assert rad.min() >= 0.0


def test_dielectric_refraction_reciprocity():
    """Snell reciprocity: refracting a refracted ray back through the
    interface (flipped normal, inverse index ratio) returns the original
    direction.  Randomized incidence angles and indices; only angles that
    refract (no TIR) participate (reference Refract, Math.cuh:293-303)."""
    import jax.numpy as jnp

    from cudaraytracer_tpu.utils.vec import refract

    r = np.random.default_rng(7)
    n = np.array([0.0, 1.0, 0.0], np.float32)
    checked = 0
    for _ in range(200):
        theta = r.uniform(0.01, np.pi / 2 - 0.01)
        phi = r.uniform(0, 2 * np.pi)
        d = np.array([np.sin(theta) * np.cos(phi),
                      -np.cos(theta),
                      np.sin(theta) * np.sin(phi)], np.float32)
        eta = float(r.uniform(1.05, 2.4))
        can, rd = refract(jnp.asarray(d), jnp.asarray(n), 1.0 / eta)
        if not bool(can):
            continue  # TIR from this side shouldn't happen entering glass
        rd = np.asarray(rd)
        rd = rd / np.linalg.norm(rd)
        # time reversal: the reversed ray travels -rd and meets the
        # interface from the glass side (outward normal -n); it must
        # refract back along -d
        can2, back = refract(jnp.asarray(-rd), jnp.asarray(-n), eta)
        assert bool(can2)  # reverse path must refract (reciprocity)
        back = np.asarray(back)
        back = back / np.linalg.norm(back)
        np.testing.assert_allclose(back, -d, atol=2e-3)
        checked += 1
    assert checked > 150  # entering glass from air never TIRs


def test_schlick_reflectance_bounds():
    """Fresnel-Schlick must stay a probability for any incidence/index."""
    import jax.numpy as jnp

    from cudaraytracer_tpu.ops.materials import _schlick

    r = np.random.default_rng(9)
    cos = jnp.asarray(r.uniform(0, 1, 256).astype(np.float32))
    for ir in (1.05, 1.5, 2.4):
        s = np.asarray(_schlick(cos, jnp.float32(ir)))
        assert (s >= 0.0).all() and (s <= 1.0).all()
    # normal incidence limit: ((1-ir)/(1+ir))^2
    s0 = float(np.asarray(_schlick(jnp.float32(1.0), jnp.float32(1.5))))
    assert abs(s0 - ((1 - 1.5) / (1 + 1.5)) ** 2) < 1e-6
