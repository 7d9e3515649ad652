"""Low-discrepancy (QMC) pixel sampling — ops/qmc.py (BEYOND-REFERENCE).

The reference draws independent curand pixel jitter per sample
(Kernel.cu:130-148); ``--qmc`` replaces it with the R2 additive
recurrence shifted per pixel by a deterministic rotation field.  The
jitter is a pure function of (pixel, global sample index), so with QMC a
background-only scene renders IDENTICALLY through every closest-hit path
(brute, BVH with the XLA traversal, BVH with the kernel) — which these
tests pin directly (a cross-path identity unavailable under PRNG jitter).
The convergence-rate payoff is measured on the CPU XLA path here.
"""

import numpy as np
import pytest

from cudaraytracer_tpu.models.camera import make_camera_params
from cudaraytracer_tpu.models.renderer import Renderer
from cudaraytracer_tpu.models.scene import DIFFUSE_LIGHT, LAMBERTIAN, Scene
from cudaraytracer_tpu.ops import qmc
from cudaraytracer_tpu.utils import rng as rngu


# ------------------------------------------------------------- sequence

def test_r2_frac_split_precision():
    """The split-precision frac(m*alpha) tracks the f64 value out to large
    indices where a naive f32 product is garbage."""
    import jax

    f = jax.jit(lambda m: qmc.r2_frac(m))
    for m in (0, 1, 7, 4095, 4096, 4097, 123_456, 2**20 + 17, 2**23 + 5):
        fx, fy = f(np.int32(m))
        ex, ey = qmc.r2_frac_np(m)
        # wrap-aware distance (frac space is a torus)
        for got, exp in ((float(fx), ex), (float(fy), ey)):
            d = abs(got - exp)
            assert min(d, 1.0 - d) < 2e-3, (m, got, exp)


def test_r2_sequence_is_stratified():
    """The first 64 jitters of any pixel cover [0,1)^2 far more evenly
    than iid uniforms: every 1/8-bin in x AND y gets 8 +/- 2 points."""
    import jax.numpy as jnp

    xs = jnp.full((1, 1), 37.0)
    ys = jnp.full((1, 1), 11.0)
    pts = np.array([
        [float(v[0, 0]) for v in qmc.qmc_jitter(xs, ys, np.int32(m))]
        for m in range(64)
    ])
    assert ((pts >= 0.0) & (pts < 1.0)).all()
    for axis in (0, 1):
        counts = np.histogram(pts[:, axis], bins=8, range=(0.0, 1.0))[0]
        assert counts.min() >= 6 and counts.max() <= 10, counts


def test_pixel_rotation_decorrelates_neighbors():
    """The rotation field must differ between adjacent pixels (otherwise
    neighbors would share the same QMC points and noise would band)."""
    import jax.numpy as jnp

    xs = jnp.arange(32, dtype=jnp.float32)[None, :] * jnp.ones((32, 1))
    ys = jnp.arange(32, dtype=jnp.float32)[:, None] * jnp.ones((1, 32))
    rx, ry = qmc.pixel_rotation(xs, ys)
    rx, ry = np.asarray(rx), np.asarray(ry)
    assert ((rx >= 0) & (rx < 1)).all() and ((ry >= 0) & (ry < 1)).all()
    # no two horizontally/vertically adjacent pixels share a rotation
    assert np.abs(np.diff(rx, axis=1)).min() > 1e-4
    assert np.abs(np.diff(rx, axis=0)).min() > 1e-4
    # and the field is roughly uniform (IGN property)
    assert abs(rx.mean() - 0.5) < 0.05 and abs(ry.mean() - 0.5) < 0.05


# ------------------------------------------------------- XLA path payoff

def _aa_scene():
    """Pure screen-space integrand: emissive rect + sphere on black sky —
    a depth-2 path terminates at the light, so the pixel value is exactly
    the jitter-integrated coverage (the anti-aliasing integral)."""
    sc = Scene(capacity=8, background_start=(0, 0, 0),
               background_end=(0, 0, 0))
    sc.add_xy_rect((0.13, 2.07, -3.0), 2.31, 1.17,
                   mat_type=DIFFUSE_LIGHT, light=4.0)
    sc.add_sphere((1.2, 1.3, -2.0), 0.618, mat_type=DIFFUSE_LIGHT, light=2.0)
    return sc


def test_xla_qmc_mean_matches_mc():
    """QMC is a consistent estimator of the same integral: high-spp QMC
    and MC renders agree."""
    sc = _aa_scene()
    cam = make_camera_params()
    W, H = 64, 48
    mc = np.asarray(Renderer(W, H).render(
        sc.device(), cam, rngu.base_key(), spp=1024, max_depth=2)) / 1024.0
    qm = np.asarray(Renderer(W, H, qmc=True).render(
        sc.device(), cam, rngu.base_key(), spp=256, max_depth=2)) / 256.0
    assert np.abs(qm - mc).mean() < 2e-3
    assert abs(qm.mean() - mc.mean()) < 5e-4


@pytest.mark.slow
def test_xla_qmc_beats_mc_on_coverage():
    """The headline property: on the AA integrand QMC error is strictly
    below MC at equal spp, and the GAP WIDENS with spp (the faster
    convergence rate) — measured 1.7x at 16 spp, 3.1x at 64 spp."""
    sc = _aa_scene()
    cam = make_camera_params()
    W, H = 96, 64
    r_mc = Renderer(W, H)
    r_qm = Renderer(W, H, qmc=True)
    ref = np.asarray(r_mc.render(
        sc.device(), cam, rngu.base_key(), spp=4096, max_depth=2)) / 4096.0

    def err(r, spp):
        img = np.asarray(r.render(
            sc.device(), cam, rngu.base_key(), spp=spp, max_depth=2)) / spp
        return float(np.abs(img - ref).mean())

    e_mc16, e_qm16 = err(r_mc, 16), err(r_qm, 16)
    e_mc64, e_qm64 = err(r_mc, 64), err(r_qm, 64)
    assert e_qm16 < 0.8 * e_mc16, (e_qm16, e_mc16)
    assert e_qm64 < 0.5 * e_mc64, (e_qm64, e_mc64)
    # rate: MC improves ~2x from 16->64 spp, QMC must beat 2.5x
    assert e_qm16 / max(e_qm64, 1e-9) > 2.5, (e_qm16, e_qm64)


def test_xla_progressive_offsets_extend_sequence():
    """Accumulating 4 one-spp frames with advancing sample_offset equals
    one 4-spp render (same R2 indices, same trace keys)."""
    sc = _aa_scene()
    cam = make_camera_params()
    r = Renderer(48, 32, qmc=True)
    sd = sc.device()
    key = rngu.base_key()
    one = np.asarray(r.render(sd, cam, key, spp=4, max_depth=2))
    acc = r.zeros_accum()
    for k in range(4):
        acc = r.accumulate(sd, cam, key, 2, acc, sample_offset=k)
    assert np.allclose(np.asarray(acc), one, atol=1e-5)


# ------------------------------------------------------ path parity

def _sky_scene():
    """No primary ray hits anything: radiance is a pure function of the
    jitter, so QMC makes the two paths bit-comparable."""
    sc = Scene(capacity=4, background_start=(1.0, 1.0, 1.0),
               background_end=(0.5, 0.7, 1.0))
    sc.add_sphere((0, 0, 1000.0), 0.1, mat_type=LAMBERTIAN,
                  albedo=(0.5, 0.5, 0.5))
    return sc


@pytest.mark.parametrize("traversal", ["xla", "interpret"])
def test_bvh_qmc_primary_identity(traversal, request):
    """With QMC, the BVH path (either traversal) and the brute reference
    trace the SAME primary rays: on a background-only scene the radiance
    matches to f32 rounding."""
    from cudaraytracer_tpu.models.bvh import build_bvh

    sc = _sky_scene()
    cam = make_camera_params()
    W, H, SPP = 16, 8, 3
    brute = np.asarray(Renderer(W, H, qmc=True).render(
        sc.device(), cam, rngu.base_key(), spp=SPP, max_depth=2))
    if traversal == "interpret":
        request.getfixturevalue("interpret_kernel")
    bvh = np.asarray(Renderer(W, H, qmc=True).render(
        sc.device(), cam, rngu.base_key(), spp=SPP, max_depth=2,
        bvh=build_bvh(sc)))
    assert np.abs(bvh - brute).max() < 1e-4


def test_bvh_qmc_progressive_extends_sequence(interpret_kernel):
    """Two progressive 1-spp frames at sample offsets 0 and 1 sum exactly
    to one 2-spp render (global index = offset + sample), and the offset
    advance changes the jitter — on the BVH path with the kernel."""
    from cudaraytracer_tpu.models.bvh import build_bvh

    sc = _sky_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    cam = make_camera_params()
    r = Renderer(16, 8, qmc=True)
    key = rngu.base_key()
    two = np.asarray(r.render(sd, cam, key, spp=2, max_depth=2, bvh=bvh))
    zero = r.zeros_accum()
    a = np.asarray(r.accumulate(sd, cam, key, 2, zero, bvh=bvh,
                                sample_offset=0))
    b = np.asarray(r.accumulate(sd, cam, key, 2, zero, bvh=bvh,
                                sample_offset=1))
    assert not np.array_equal(a, b)
    assert np.abs((a + b) - two).max() < 1e-5


def test_viewer_qmc_toggle_e2e():
    """HTTP surface: the QMC checkbox posts {"qmc": true}; the server
    rebuilds the renderer with the R2 sampler, /state reports it, and it
    toggles cleanly back off — same static-rebuild lever as the NEE
    toggle (test_nee_viewer.py)."""
    import json
    import urllib.request

    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer.app import Application
    from cudaraytracer_tpu.viewer.server import ViewerServer

    def get(port, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return r.read()

    def post(port, path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            method="POST")
        with urllib.request.urlopen(req) as r:
            return r.read()

    cfg = RenderConfig(width=32, height=16, spp=1, max_depth=3,
                       scene="default", accel="bvh", progressive=True)
    app = Application(cfg)
    rl = app.setup_default_layers()
    app.run(max_frames=1)
    assert not rl.renderer.qmc
    server = ViewerServer(app, port=0)
    server.start()
    port = server.port
    try:
        assert json.loads(get(port, "/state"))["options"]["qmc"] is False
        post(port, "/options", {"qmc": True})
        app.run(max_frames=2)
        assert json.loads(get(port, "/state"))["options"]["qmc"] is True
        assert rl.renderer.qmc
        img = rl.framebuffer_rgba8()
        assert np.isfinite(img[..., :3]).all() and img[..., :3].sum() > 0
        post(port, "/options", {"qmc": False})
        app.run(max_frames=1)
        assert json.loads(get(port, "/state"))["options"]["qmc"] is False
        assert not rl.renderer.qmc
    finally:
        server.stop()
        app.close()
