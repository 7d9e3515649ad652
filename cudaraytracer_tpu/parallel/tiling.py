"""Multi-chip rendering: shard the pixel grid and sample stream over a mesh.

The reference is strictly single-GPU — its only parallelism is one CUDA
thread per pixel (reference: CudaRayTracer/src/Cuda/Kernel.cu:102-158,
183-184) and it has no distributed communication at all (SURVEY.md §2.7).
This module is the multi-device scaling story that takes its place:

  * a 2D ``jax.sharding.Mesh`` with axes ``("rows", "samples")``;
  * the image is split into horizontal bands over the ``rows`` axis (data
    parallelism over pixels — each device traces its own wavefront, zero
    communication during the bounce loop);
  * samples-per-pixel are split over the ``samples`` axis (sample
    parallelism — independent Monte-Carlo streams), combined with a single
    ``psum`` (NCCL on GPUs) at frame assembly;
  * the scene, its BVH and the camera are small and replicated on every
    device.

Communication cost per frame is exactly one psum of the local framebuffer
band over the ``samples`` axis — everything else stays on the device.  With a
``samples`` axis of size 1 it degrades to pure row-banding with no
collectives, which is the ideal layout when HBM per chip allows it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.renderer import render_radiance


def _as_i32(x):
    """int32-ify a scalar WITHOUT an eager default-device dispatch.

    An eager ``jnp.asarray(python_int)`` runs convert_element_type on the
    DEFAULT device, which need not be in the mesh.  Plain python/numpy
    scalars become numpy (zero device work; shard_map moves them to the
    mesh at execution); traced or committed jax values convert in-trace /
    on their own device.
    """
    import numpy as np

    if isinstance(x, (int, float, np.integer, np.floating, np.ndarray)):
        return np.asarray(x, np.int32)
    return jnp.asarray(x, jnp.int32)


def make_mesh(n_rows: int | None = None, n_samples: int = 1, devices=None) -> Mesh:
    """Build a ("rows", "samples") mesh over the available devices."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_rows is None:
        n_rows = n // n_samples
    if n_rows * n_samples != n:
        raise ValueError(f"{n_rows}x{n_samples} mesh != {n} devices")
    arr = np.asarray(devices).reshape(n_rows, n_samples)
    return Mesh(arr, ("rows", "samples"))


def render_sharded(
    scene,
    cam,
    key,
    spp,
    max_depth,
    *,
    width: int,
    height: int,
    mesh: Mesh,
    camera_model: str = "two_plane",
    t_min: float = 0.001,
    block: int = 64,
    hit_fn=None,
    bvh=None,
) -> jnp.ndarray:
    """Render one frame over the mesh; returns f32[H,W,3] radiance sharded
    by row bands.

    ``spp`` must be divisible by the samples axis; ``height`` by the rows
    axis.  The result is the SUM over spp samples (divide to display), same
    contract as models.renderer.render_radiance.  A ``bvh`` (replicated)
    selects the BVH hit function on every device (models/bvh.py: the
    closest-hit kernel on GPUs).
    """
    n_rows = mesh.shape["rows"]
    n_samp = mesh.shape["samples"]
    if height % n_rows:
        raise ValueError(f"height {height} not divisible by rows axis {n_rows}")
    tile_h = height // n_rows

    bvh_args = () if bvh is None else (bvh,)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(),) * (5 + len(bvh_args)),
        out_specs=P("rows", None, None),
        # loop carries inside trace() mix replicated inits with axis_index-
        # varying ray data; the computation is correct (scene replicated,
        # rays per-device), so skip the varying-manual-axes bookkeeping
        check_vma=False,
    )
    def _local(scene, cam, key, spp, max_depth, *bvh_args):
        ri = lax.axis_index("rows")
        si = lax.axis_index("samples")
        local_spp = spp // n_samp
        fn = hit_fn
        if bvh_args:
            from ..models.bvh import make_bvh_hit_fn

            fn = make_bvh_hit_fn(bvh_args[0], scene, t_min=t_min)
        rad = render_radiance(
            scene, cam, key, local_spp, max_depth,
            width=width, height=height, camera_model=camera_model,
            t_min=t_min, block=block, hit_fn=fn,
            y0=ri * tile_h, tile_h=tile_h,
            sample_offset=si * local_spp,
        )
        # one collective per frame: combine the sample-parallel streams
        rad = lax.psum(rad, "samples")
        return rad

    return _local(scene, cam, key, _as_i32(spp), _as_i32(max_depth),
                  *bvh_args)


class ShardedRenderer:
    """Jit-compiled multi-chip frame renderer (the scaling analog of
    models.renderer.Renderer)."""

    def __init__(
        self,
        width: int,
        height: int,
        mesh: Mesh | None = None,
        n_samples_axis: int = 1,
        camera_model: str = "two_plane",
        t_min: float = 0.001,
        block: int = 64,
    ):
        self.width = int(width)
        self.height = int(height)
        self.mesh = mesh if mesh is not None else make_mesh(n_samples=n_samples_axis)
        self.camera_model = camera_model

        @jax.jit
        def _render(scene, cam, key, spp, max_depth, bvh=None):
            return render_sharded(
                scene, cam, key, spp, max_depth,
                width=self.width, height=self.height, mesh=self.mesh,
                camera_model=self.camera_model, t_min=t_min, block=block,
                bvh=bvh,
            )

        self._render = _render

    def render(self, scene, cam, key, spp=36, max_depth=12, bvh=None):
        """Radiance sum over spp samples; pass a replicated ``bvh``
        (models.bvh.BVHData) for the BVH path."""
        return self._render(scene, cam, key, spp, max_depth, bvh)

    def replicate(self, tree):
        """Place a host pytree on the mesh fully replicated."""
        sharding = NamedSharding(self.mesh, P())
        return jax.device_put(tree, sharding)
