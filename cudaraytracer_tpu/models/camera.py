"""Camera: device-side ray generation + host-side fly controller.

Two ray-generation models:

  * ``two_plane`` — the reference's exact camera model: rays go from a near
    plane offset by ``fov * forward`` to a far plane offset by
    ``(10 / fov) * forward``, with screen offsets scaled by 1/width on both
    axes (reference: CudaRayTracer/src/Cuda/Kernel.cu:130-148 and the
    InputStruct fill at CudaLayer.cpp:43-65).  Default, for behavioral parity.
  * ``look_at`` — the standard RTOW thin-lens camera with vertical fov,
    aspect, aperture (defocus blur) and focus distance; used by the RTOW
    final-scene benchmark config (BASELINE.json configs[1]).

The host controller reproduces the reference fly camera
(reference: CudaRayTracer/src/Renderer/Camera.cpp:28-118): WASD/Space/Ctrl
movement at SPEED=0.05 (x2 with Shift), yaw/pitch mouse look at
SENSITIVITY=0.1 with pitch clamped to +/-89 deg, C resets position, scroll
zooms fov clamped to [1, 120] deg.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..utils import rng as rngu
from ..utils.vec import cross, normalize

SPEED = 0.05  # reference Camera.h:6
SENSITIVITY = 0.1  # reference Camera.h:7
DEFAULT_POSITION = (0.0, 2.0, 12.0)  # reference CudaLayer.cpp:43
DEFAULT_ORIENTATION = (0.0, 0.0, -1.0)  # reference Camera.h m_Orientation
DEFAULT_FOV_DEG = 45.0  # reference Camera.h m_Fov
DEFAULT_NEAR = 0.1  # reference Camera.h m_NearPlane
DEFAULT_FAR = 10.0  # reference Camera.h m_FarPlane


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Device-side camera uniforms (analog of InputStruct,
    reference: CudaRayTracer/src/Utils/SharedStructs.h:3-24, minus the
    background colors which live on SceneData)."""

    origin: jax.Array  # f32[3]
    forward: jax.Array  # f32[3] (reference m_Orientation)
    up: jax.Array  # f32[3] orthonormalized camera up
    near: jax.Array  # f32[] near plane scale
    far: jax.Array  # f32[] far plane scale
    fov: jax.Array  # f32[] vertical fov in RADIANS
    aperture: jax.Array  # f32[] lens diameter (0 = pinhole; look_at model only)
    focus_dist: jax.Array  # f32[] focus distance (look_at model only)


def make_camera_params(
    origin=DEFAULT_POSITION,
    forward=DEFAULT_ORIENTATION,
    world_up=(0.0, 1.0, 0.0),
    fov_deg: float = DEFAULT_FOV_DEG,
    near: float = DEFAULT_NEAR,
    far: float = DEFAULT_FAR,
    aperture: float = 0.0,
    focus_dist: float = 10.0,
) -> CameraParams:
    """Build params the way CudaLayer fills InputStruct (CudaLayer.cpp:45-62):
    up is re-orthonormalized from forward and world up.

    Host-side NumPy on purpose: the fly camera rebuilds params EVERY frame,
    and eager jnp ops each cost a device dispatch.  NumPy leaves enter jit
    at the call boundary as one small transfer instead."""
    import numpy as np

    fwd = np.asarray(forward, np.float32)
    wup = np.asarray(world_up, np.float32)
    right = np.cross(fwd, wup)
    right = right / max(float(np.linalg.norm(right)), 1e-12)
    up = np.cross(fwd, right)
    up = up / max(float(np.linalg.norm(up)), 1e-12)
    # glm cross(orientation, right) points down for the default frame; the
    # reference then uses it directly, making v positive toward screen-up
    # because v = (center.y - y).  We keep the same convention: up here is the
    # vector used by the kernel, i.e. cross(forward, right) normalized.
    return CameraParams(
        origin=np.asarray(origin, np.float32),
        forward=fwd,
        up=up.astype(np.float32),
        near=np.float32(near),
        far=np.float32(far),
        fov=np.float32(math.radians(fov_deg)),
        aperture=np.float32(aperture),
        focus_dist=np.float32(focus_dist),
    )


def generate_rays_two_plane(
    cam: CameraParams, width: int, height: int, key: jax.Array,
    y0=0, tile_h: int | None = None, xi=None,
):
    """Jittered primary rays, reference two-plane model (Kernel.cu:130-148).

    Returns (org[R,3], dir[R,3]) with R = width*tile_h, row-major pixels.
    ``y0``/``tile_h`` select a horizontal band of the image (for multi-chip
    row sharding); coordinates stay in the full-image frame.  ``xi``
    (f32[2,tile_h,width], optional) overrides the pixel jitter — the QMC
    sampler (ops/qmc.py) supplies low-discrepancy offsets this way.
    """
    if tile_h is None:
        tile_h = height
    x = jnp.arange(width, dtype=jnp.float32)[None, :]
    y = (jnp.arange(tile_h, dtype=jnp.float32) + jnp.asarray(y0, jnp.float32))[:, None]
    # key=None: deterministic pixel-CENTER rays (0.5 offsets) — the
    # G-buffer/feature passes use this so features are a pure function of
    # (scene, camera) with no pseudo-jitter at silhouettes
    if xi is None:
        xi = (jnp.full((2, tile_h, width), 0.5, jnp.float32) if key is None
              else jax.random.uniform(key, (2, tile_h, width)))
    # u,v both divided by WIDTH, v measured downward from the image center
    # (Kernel.cu:139-140).
    u = ((x - width / 2.0) + xi[0]) / width  # [H,W]
    v = ((height / 2.0 - y) + xi[1]) / width

    right = normalize(cross(cam.up, cam.forward))
    dist = u[..., None] * right + v[..., None] * cam.up  # [H,W,3]
    start = cam.near * dist + cam.origin + cam.fov * cam.forward
    second = cam.far * dist + (1.0 / cam.fov * 10.0) * cam.forward + cam.origin
    dirn = normalize(second - start)
    r = width * tile_h
    return start.reshape(r, 3), dirn.reshape(r, 3)


def look_at_frame(cam: CameraParams, aspect: float):
    """Thin-lens frustum of the RTOW look_at camera: returns
    (u_axis, v_axis, lower_left, horizontal, vertical), used by the raygen
    below.

    RTOW convention: w points backward; basis built from WORLD up, not the
    reference's inverted camera-up uniform (which generate_rays_two_plane
    keeps for parity).
    """
    half_h = jnp.tan(cam.fov / 2.0)
    half_w = aspect * half_h
    w = normalize(-cam.forward)
    world_up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    u_axis = normalize(cross(world_up, w))
    v_axis = cross(w, u_axis)
    lower_left = (
        cam.origin
        - half_w * cam.focus_dist * u_axis
        - half_h * cam.focus_dist * v_axis
        - cam.focus_dist * w
    )
    horizontal = 2.0 * half_w * cam.focus_dist * u_axis
    vertical = 2.0 * half_h * cam.focus_dist * v_axis
    return u_axis, v_axis, lower_left, horizontal, vertical


def generate_rays_look_at(
    cam: CameraParams, width: int, height: int, key: jax.Array,
    y0=0, tile_h: int | None = None, xi=None,
):
    """Jittered primary rays, standard RTOW thin-lens camera.

    forward/up/fov/aperture/focus_dist are read from ``cam``; fov is the
    vertical field of view.  Supports defocus blur when aperture > 0.
    ``xi`` overrides the pixel jitter (QMC sampler); the lens-disk draw
    stays PRNG-driven either way.
    """
    if tile_h is None:
        tile_h = height
    u_axis, v_axis, lower_left, horizontal, vertical = look_at_frame(
        cam, width / height)

    x = jnp.arange(width, dtype=jnp.float32)[None, :]
    y = (jnp.arange(tile_h, dtype=jnp.float32) + jnp.asarray(y0, jnp.float32))[:, None]
    if key is None:
        # deterministic pixel-center PINHOLE rays (see two_plane note)
        if xi is None:
            xi = jnp.full((2, tile_h, width), 0.5, jnp.float32)
        lens = jnp.zeros((tile_h, width, 3), jnp.float32)
    else:
        kj, ka = jax.random.split(key)
        if xi is None:
            xi = jax.random.uniform(kj, (2, tile_h, width))
        lens = (cam.aperture / 2.0) * rngu.in_unit_disk(ka, (tile_h, width))
    s = (x + xi[0]) / width  # [H,W] in [0,1)
    t = (height - 1.0 - y + xi[1]) / height  # image row 0 = top of screen

    offset = lens[..., 0:1] * u_axis + lens[..., 1:2] * v_axis

    org = cam.origin + offset
    target = lower_left + s[..., None] * horizontal + t[..., None] * vertical
    dirn = target - org
    r = width * tile_h
    org = jnp.broadcast_to(org, (tile_h, width, 3))
    return org.reshape(r, 3), dirn.reshape(r, 3)


RAY_GENERATORS = {
    "two_plane": generate_rays_two_plane,
    "look_at": generate_rays_look_at,
}


class FlyCamera:
    """Host-side interactive camera (reference Camera.cpp:28-118)."""

    def __init__(
        self,
        position=DEFAULT_POSITION,
        fov_deg: float = DEFAULT_FOV_DEG,
        near: float = DEFAULT_NEAR,
        far: float = DEFAULT_FAR,
    ):
        self.home = tuple(float(c) for c in position)
        self.position = list(self.home)
        self.yaw = 270.0  # reference Camera.h m_Yaw
        self.pitch = 0.0
        self.fov_deg = float(fov_deg)
        self.near = float(near)
        self.far = float(far)
        self.speed = SPEED
        self.sensitivity = SENSITIVITY
        self.version = 0
        self._update_orientation()

    def _update_orientation(self):
        cy, sy = math.cos(math.radians(self.yaw)), math.sin(math.radians(self.yaw))
        cp, sp = math.cos(math.radians(self.pitch)), math.sin(math.radians(self.pitch))
        d = (cy * cp, sp, sy * cp)
        n = math.sqrt(sum(c * c for c in d))
        self.orientation = tuple(c / n for c in d)

    # -------- input handling (keys are lowercase strings / names) --------
    def process_keys(self, keys, shift: bool = False):
        """Apply one tick of held keys: w/a/s/d/space/ctrl move, c resets
        (Camera.cpp:39-68)."""
        speed = self.speed * (2.0 if shift else 1.0)
        ox, oy, oz = self.orientation
        # right = normalize(cross(orientation, up)) with up = (0,1,0)
        rx, ry, rz = -oz, 0.0, ox
        rn = math.sqrt(rx * rx + rz * rz) or 1.0
        rx, rz = rx / rn, rz / rn
        moved = False
        for k in keys:
            if k == "w":
                self.position = [p + speed * o for p, o in zip(self.position, (ox, oy, oz))]
            elif k == "s":
                self.position = [p - speed * o for p, o in zip(self.position, (ox, oy, oz))]
            elif k == "d":
                self.position = [p + speed * o for p, o in zip(self.position, (rx, ry, rz))]
            elif k == "a":
                self.position = [p - speed * o for p, o in zip(self.position, (rx, ry, rz))]
            elif k == "space":
                self.position[1] += speed
            elif k == "ctrl":
                self.position[1] -= speed
            elif k == "c":
                self.position = list(self.home)
            else:
                continue
            moved = True
        if moved:
            self.version += 1
        return moved

    def process_mouse(self, dx: float, dy: float):
        """Right-drag look: dx right, dy up, in pixels (Camera.cpp:71-116)."""
        self.yaw += dx * self.sensitivity
        self.pitch += dy * self.sensitivity
        self.pitch = max(-89.0, min(89.0, self.pitch))
        self._update_orientation()
        self.version += 1

    def process_scroll(self, dy: float):
        """Scroll zoom, fov clamped to [1, 120] deg (Camera.cpp:28-35)."""
        self.fov_deg = max(1.0, min(120.0, self.fov_deg - dy))
        self.version += 1

    def params(self, aperture: float = 0.0, focus_dist: float = 10.0) -> CameraParams:
        return make_camera_params(
            origin=self.position,
            forward=self.orientation,
            fov_deg=self.fov_deg,
            near=self.near,
            far=self.far,
            aperture=aperture,
            focus_dist=focus_dist,
        )
