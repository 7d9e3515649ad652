"""Texture sampling tests (semantics of Texture.cuh:32-109)."""

import numpy as np

from cudaraytracer_tpu.ops import textures as tex


def sample(tex_type, u=0.0, v=0.0, p=(0.0, 0.0, 0.0), albedo=(1.0, 0.0, 0.0),
           albedo2=(0.0, 1.0, 0.0), tex_id=-1, atlas=None, tex_hw=None):
    n = 1
    if atlas is None:
        atlas = np.zeros((1, 4, 4, 3), np.uint8)
        tex_hw = np.zeros((1, 2), np.int32)
    return np.asarray(
        tex.sample_texture(
            np.full(n, tex_type, np.int32),
            np.tile(np.asarray(albedo, np.float32), (n, 1)),
            np.tile(np.asarray(albedo2, np.float32), (n, 1)),
            np.full(n, tex_id, np.int32),
            np.full(n, u, np.float32),
            np.full(n, v, np.float32),
            np.tile(np.asarray(p, np.float32), (n, 1)),
            atlas, tex_hw,
        )
    )[0]


def test_constant():
    np.testing.assert_allclose(sample(tex.CONSTANT, albedo=(0.2, 0.3, 0.4)), [0.2, 0.3, 0.4])


def test_checker_sign():
    # sines = sin(10x)sin(10y)sin(10z); p=(pi/20,pi/20,pi/20) -> all sin(pi/2)=1 -> even
    p_even = (np.pi / 20,) * 3
    np.testing.assert_allclose(sample(tex.CHECKER, p=p_even), [0.0, 1.0, 0.0])
    # flip one axis: sin negative -> odd color
    p_odd = (np.pi / 20, np.pi / 20, -np.pi / 20)
    np.testing.assert_allclose(sample(tex.CHECKER, p=p_odd), [1.0, 0.0, 0.0])


def test_image_lookup_nearest_and_vflip():
    # 2x2 image: row0 = [R, G], row1 = [B, W]
    atlas = np.zeros((1, 4, 4, 3), np.uint8)
    atlas[0, 0, 0] = (255, 0, 0)
    atlas[0, 0, 1] = (0, 255, 0)
    atlas[0, 1, 0] = (0, 0, 255)
    atlas[0, 1, 1] = (255, 255, 255)
    hw = np.array([[2, 2]], np.int32)
    # u=0.1,v=0.9 -> i=0, v flipped: 1-0.9=0.1 -> j=0 -> red
    np.testing.assert_allclose(
        sample(tex.IMAGE, u=0.1, v=0.9, tex_id=0, atlas=atlas, tex_hw=hw), [1, 0, 0]
    )
    # u=0.9,v=0.1 -> i=1, j=1 -> white
    np.testing.assert_allclose(
        sample(tex.IMAGE, u=0.9, v=0.1, tex_id=0, atlas=atlas, tex_hw=hw), [1, 1, 1]
    )
    # u=1.0 clamps to last column, v=1.0 flips to top row (Texture.cuh:92-99)
    np.testing.assert_allclose(
        sample(tex.IMAGE, u=1.0, v=1.0, tex_id=0, atlas=atlas, tex_hw=hw), [0, 1, 0]
    )


def test_image_missing_is_cyan():
    # reference returns (0,1,1) for null image data (Texture.cuh:88-89)
    np.testing.assert_allclose(sample(tex.IMAGE, tex_id=-1), [0.0, 1.0, 1.0])


def test_empty_atlas_slot_is_missing_data():
    """An image texture pointing at a never-loaded (or freed) atlas slot is
    MISSING DATA: the reference returns cyan for a null image
    (Texture.cuh:88-89).  The sampler must treat empty slots like tex_id=-1
    rather than sampling zeroed memory."""
    import jax.numpy as jnp
    import numpy as np

    from cudaraytracer_tpu.models.scene import IMAGE, LAMBERTIAN, Scene
    from cudaraytracer_tpu.ops import textures

    scene = Scene(capacity=4)
    scene.add_sphere((0, 1, -3), 1.0, mat_type=LAMBERTIAN,
                     tex_type=IMAGE, tex_id=2)  # slot 2 never loaded
    sd = scene.device()

    # XLA path: cyan fallback
    out = textures.sample_texture(
        jnp.full((4,), IMAGE, jnp.int32),
        jnp.ones((4, 3)), jnp.zeros((4, 3)),
        jnp.full((4,), 2, jnp.int32),
        jnp.full((4,), 0.5), jnp.full((4,), 0.5), jnp.zeros((4, 3)),
        sd.atlas, sd.tex_hw,
    )
    np.testing.assert_allclose(np.asarray(out), [[0.0, 1.0, 1.0]] * 4)
