"""Sample-stream independence for the sharded renderer.

Every (row band, sample stream) device of the rows x samples mesh draws
its randomness from counter-based keys: ``frame_key(base, sample_offset +
s)`` with the band's first row ``y0`` folded in (models/renderer.py
render_radiance; parallel/tiling.py passes ``y0 = row * band`` and
``sample_offset = stream * local_spp``).  Two properties matter:

1. the (band, global sample index) -> key map is injective over the mesh
   shapes used, so no two devices draw identical randomness;
2. a device's stream is a pure function of those counters — rendering the
   same band and samples again reproduces it bit for bit, and shifting
   either counter decorrelates it.
"""

import jax
import numpy as np
import pytest

from cudaraytracer_tpu.models import scenes
from cudaraytracer_tpu.models.renderer import render_radiance
from cudaraytracer_tpu.utils import rng as rngu


def _key(base, y0, sample):
    k = rngu.frame_key(base, sample)
    return tuple(np.asarray(jax.random.key_data(
        jax.random.fold_in(k, y0))).ravel().tolist())


@pytest.mark.parametrize("n_rows,n_samples", [(8, 1), (4, 2), (2, 2),
                                              (1, 8)])
def test_stream_keys_are_distinct(n_rows, n_samples):
    """All (band, stream, sample) keys of a 720-row frame at 4 spp per
    stream are distinct."""
    base = rngu.base_key()
    band, local = 720 // n_rows, 4
    keys = {_key(base, r * band, s * local + i)
            for r in range(n_rows) for s in range(n_samples)
            for i in range(local)}
    assert len(keys) == n_rows * n_samples * local


def test_band_stream_is_deterministic_and_shifts_decorrelate():
    sc = scenes.default_scene()
    sd, cam = sc.device(), scenes.default_scene_camera()
    kw = dict(width=16, height=16, tile_h=8)

    def band(y0, offset):
        return np.asarray(render_radiance(sd, cam, rngu.base_key(), 2, 3,
                                          y0=y0, sample_offset=offset, **kw))

    a = band(0, 0)
    np.testing.assert_array_equal(a, band(0, 0))  # deterministic
    b = band(0, 2)  # the next sample stream
    assert (np.abs(a - b).max(-1) > 1e-6).mean() > 0.9
    c = band(8, 0)  # the next row band, same samples
    assert np.isfinite(c).all() and not np.array_equal(a, c)
