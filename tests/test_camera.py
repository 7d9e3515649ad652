"""Camera tests: two-plane ray-gen oracle (Kernel.cu:130-148) and the fly
controller semantics (Camera.cpp:28-118)."""

import math

import jax
import numpy as np

from cudaraytracer_tpu.models import camera as cam_mod


def test_two_plane_matches_oracle():
    cam = cam_mod.make_camera_params()
    w, h = 8, 6
    key = jax.random.PRNGKey(0)
    org, dirn = cam_mod.generate_rays_two_plane(cam, w, h, key)
    org, dirn = np.asarray(org).reshape(h, w, 3), np.asarray(dirn).reshape(h, w, 3)

    # NumPy oracle of Kernel.cu:130-148 with the same jitter draws
    xi = np.asarray(jax.random.uniform(key, (2, h, w)))
    origin = np.array([0.0, 2.0, 12.0])
    forward = np.array([0.0, 0.0, -1.0])
    up = np.array([0.0, -1.0, 0.0])  # cross chain makes camera up world-down
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    fov = math.radians(45.0)
    near, far = 0.1, 10.0
    for y in range(h):
        for x in range(w):
            u = ((x - w / 2.0) + xi[0, y, x]) / w
            v = ((h / 2.0 - y) + xi[1, y, x]) / w
            dist = u * right + v * up
            start = near * dist + origin + fov * forward
            second = far * dist + (1.0 / fov * 10.0) * forward + origin
            d = second - start
            d /= np.linalg.norm(d)
            np.testing.assert_allclose(org[y, x], start, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(dirn[y, x], d, rtol=1e-3, atol=1e-5)


def test_look_at_center_ray_is_forward():
    cam = cam_mod.make_camera_params(
        origin=(0, 0, 0), forward=(0, 0, -1), fov_deg=60.0, focus_dist=5.0
    )
    w = h = 64
    org, dirn = cam_mod.generate_rays_look_at(cam, w, h, jax.random.PRNGKey(1))
    dirn = np.asarray(dirn).reshape(h, w, 3)
    center = dirn[h // 2, w // 2]
    center = center / np.linalg.norm(center)
    assert center[2] < -0.99
    # top rows look up (positive y), bottom rows look down
    assert dirn[0, w // 2][1] > 0 > dirn[-1, w // 2][1]


def test_look_at_aperture_jitters_origin():
    cam = cam_mod.make_camera_params(origin=(0, 0, 0), aperture=2.0, focus_dist=5.0)
    org, _ = cam_mod.generate_rays_look_at(cam, 16, 16, jax.random.PRNGKey(2))
    org = np.asarray(org)
    assert np.abs(org).max() > 0.01  # lens offsets applied
    assert np.abs(org).max() <= 1.0 + 1e-5  # within aperture/2 radius


def test_fly_camera_movement():
    c = cam_mod.FlyCamera()
    p0 = list(c.position)
    c.process_keys(["w"])  # forward = (0,0,-1)
    assert c.position[2] < p0[2]
    c.process_keys(["d"])  # right = +x for default yaw
    assert c.position[0] > p0[0]
    c.process_keys(["space"])
    assert c.position[1] > p0[1]
    c.process_keys(["c"])  # reset (Camera.cpp:66-68)
    assert c.position == list(c.home)
    # shift doubles speed
    c2 = cam_mod.FlyCamera()
    c2.process_keys(["w"], shift=True)
    assert abs(c2.position[2] - c2.home[2]) > abs(p0[2] - c.home[2]) * 1.5


def test_fly_camera_pitch_clamp_and_fov():
    c = cam_mod.FlyCamera()
    c.process_mouse(0.0, 1e6)
    assert c.pitch == 89.0
    c.process_mouse(0.0, -1e7)
    assert c.pitch == -89.0
    c.process_scroll(1e5)
    assert c.fov_deg == 1.0
    c.process_scroll(-1e6)
    assert c.fov_deg == 120.0


def test_fly_camera_yaw_look():
    c = cam_mod.FlyCamera()
    # default yaw 270 -> orientation (0,0,-1)
    np.testing.assert_allclose(c.orientation, (0, 0, -1), atol=1e-6)
    c.process_mouse(900.0, 0.0)  # +90 deg yaw at sensitivity 0.1
    np.testing.assert_allclose(c.orientation, (1, 0, 0), atol=1e-5)
