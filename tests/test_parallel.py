"""Multi-chip sharding tests on the 8-virtual-CPU-device mesh."""

import jax
import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.parallel import ShardedRenderer, make_mesh, render_sharded
from cudaraytracer_tpu.utils import rng as rngu


@pytest.fixture(scope="module")
def setup():
    scene = scenes.default_scene()
    return scene.device(), scenes.default_scene_camera()


def test_mesh_shapes():
    m = make_mesh()
    assert m.shape == {"rows": 8, "samples": 1}
    m = make_mesh(n_samples=2)
    assert m.shape == {"rows": 4, "samples": 2}
    with pytest.raises(ValueError):
        make_mesh(n_rows=3, n_samples=3)


@pytest.mark.slow
@pytest.mark.parametrize("n_samples", [1, 2])
def test_sharded_render_matches_statistics(setup, n_samples):
    sd, cam = setup
    mesh = make_mesh(n_samples=n_samples)
    w, h, spp, depth = 32, 32, 4, 4
    rad_sh = render_sharded(
        sd, cam, rngu.base_key(), spp, depth, width=w, height=h, mesh=mesh
    )
    assert rad_sh.shape == (h, w, 3)
    rad_sh = np.asarray(rad_sh) / spp
    rad_1 = np.asarray(
        render_radiance(sd, cam, rngu.base_key(), spp, depth, width=w, height=h)
    ) / spp
    assert np.isfinite(rad_sh).all()
    # different RNG streams -> only statistical agreement expected
    assert abs(rad_sh.mean() - rad_1.mean()) < 0.08
    # no empty bands: every row band produced content
    band = h // mesh.shape["rows"]
    for b in range(mesh.shape["rows"]):
        assert rad_sh[b * band : (b + 1) * band].sum() > 0


@pytest.mark.slow
def test_sharded_renderer_class(setup):
    sd, cam = setup
    r = ShardedRenderer(32, 32, n_samples_axis=2)
    sd_rep = r.replicate(sd)
    out = r.render(sd_rep, cam, rngu.base_key(), spp=2, max_depth=3)
    assert out.shape == (32, 32, 3)
    assert np.isfinite(np.asarray(out)).all()


def test_height_not_divisible_raises(setup):
    sd, cam = setup
    mesh = make_mesh()
    with pytest.raises(ValueError):
        render_sharded(sd, cam, rngu.base_key(), 1, 2, width=16, height=17, mesh=mesh)


@pytest.mark.parametrize("n_rows,n_samples", [(2, 2), (4, 2), (8, 1)])
def test_sharded_bands_match_single_device(setup, n_rows, n_samples):
    """Each row band of the sharded frame equals a single-device render of
    that band with the same seeds: the samples axis sums disjoint sample
    streams (sample_offset = stream * local spp) with one psum.  The same
    comparison chip_smoke.py --multi makes on four GPUs."""
    sd, cam = setup
    n = n_rows * n_samples
    mesh = make_mesh(n_rows=n_rows, n_samples=n_samples,
                     devices=jax.devices()[:n])
    w, h, spp, depth = 16, 8 * n_rows, 2 * n_samples, 3
    out = np.asarray(render_sharded(
        sd, cam, rngu.base_key(), spp, depth, width=w, height=h, mesh=mesh))
    band = h // n_rows
    local = spp // n_samples
    for b in range(n_rows):
        want = sum(
            np.asarray(render_radiance(
                sd, cam, rngu.base_key(), local, depth, width=w, height=h,
                y0=b * band, tile_h=band, sample_offset=s * local))
            for s in range(n_samples))
        # float tolerance: the psum adds the streams in another order
        np.testing.assert_allclose(out[b * band:(b + 1) * band], want,
                                   rtol=1e-5, atol=1e-5)


def test_sharded_bvh_feature_probe():
    """Every beyond-reference branch at once (noise texture, sphere and
    yaw-rotated box media, motion blur, NEE light table) through the
    sharded frame with the BVH hit function on a 4x2 mesh: finite, lit,
    and band-for-band equal to the single-device BVH render."""
    from cudaraytracer_tpu.models.bvh import build_bvh, make_bvh_hit_fn

    sc = scenes.all_feature_probe_scene()
    sd, bvh = sc.device(), build_bvh(sc)
    cam = scenes.cornell_like_camera()
    mesh = make_mesh(n_rows=4, n_samples=2)
    w, h = 16, 16
    hit_fn = make_bvh_hit_fn(bvh, sd)
    out = np.asarray(render_sharded(
        sd, cam, rngu.base_key(3), 2, 3, width=w, height=h, mesh=mesh,
        hit_fn=hit_fn))
    assert np.isfinite(out).all() and out.mean() > 0.001
    want = sum(np.asarray(render_radiance(
        sd, cam, rngu.base_key(3), 1, 3, width=w, height=h, y0=4, tile_h=4,
        sample_offset=s, hit_fn=hit_fn)) for s in range(2))
    np.testing.assert_allclose(out[4:8], want, rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_dryrun_multichip_on_cpu_mesh():
    """__graft_entry__.dryrun_multichip on an explicitly requested CPU
    mesh in a fresh process: the platform and the device count are pinned
    by the environment, never chosen behind the caller's back."""
    import os
    import subprocess
    import sys

    code = (
        "from __graft_entry__ import dryrun_multichip\n"
        "dryrun_multichip(8)\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, env=env,
        capture_output=True, text=True, timeout=570,
    )
    assert out.returncode == 0, f"stdout={out.stdout}\nstderr={out.stderr}"
    assert "dryrun_multichip OK" in out.stdout


def test_dryrun_multichip_needs_devices():
    """Fewer devices than asked for is an error, not a virtual mesh."""
    from __graft_entry__ import dryrun_multichip

    with pytest.raises(RuntimeError, match="needs 64 devices"):
        dryrun_multichip(64)
