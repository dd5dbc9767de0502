"""Camera / DirectX-convention matrix tests."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.core import camera as cam


def test_look_at_lh_maps_eye_to_origin():
    eye, at, up = (1.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    view = cam.look_at_lh(eye, at, up)
    out = cam.transform_point_row(eye, view)
    np.testing.assert_allclose(out, [0, 0, 0], atol=1e-12)
    # `at` should land on the +z axis at distance |at - eye| (LH convention).
    out_at = cam.transform_point_row(at, view)
    np.testing.assert_allclose(out_at[:2], [0, 0], atol=1e-12)
    assert out_at[2] == pytest.approx(np.linalg.norm(np.asarray(eye)))


def test_perspective_lh_depth_range():
    proj = cam.perspective_fov_lh(math.radians(45.0), 1.0, 0.01, 125.0)
    # Points at z = zn map to NDC depth 0; z = zf map to 1 (after w divide).
    near = np.array([0.0, 0.0, 0.01, 1.0]) @ proj
    far = np.array([0.0, 0.0, 125.0, 1.0]) @ proj
    assert near[2] / near[3] == pytest.approx(0.0, abs=1e-9)
    assert far[2] / far[3] == pytest.approx(1.0, abs=1e-9)


def test_rotation_y_row_convention():
    # Row-vector XMMatrixRotationY: x' = x c + z s, z' = -x s + z c.
    rot = cam.rotation_y(math.pi / 2)
    out = cam.transform_point_row((1.0, 0.0, 0.0), rot)
    np.testing.assert_allclose(out, [0, 0, -1], atol=1e-12)
    out = cam.transform_point_row((0.0, 0.0, 1.0), rot)
    np.testing.assert_allclose(out, [1, 0, 0], atol=1e-12)


def test_default_camera_pose():
    # Renderer.cpp:252-268: eye (0,5.3,-17) rotated 45deg about Y.
    c = cam.Camera(eye=(0.0, 5.3, -17.0), at=(0.0, 0.0, 0.0), initial_y_rotation_deg=45.0)
    s = 17.0 * math.sin(math.radians(45.0))
    np.testing.assert_allclose(c.eye, [-s, 5.3, -s], atol=1e-12)
    np.testing.assert_allclose(c.at, [0, 0, 0], atol=1e-12)
    assert np.linalg.norm(c.up) == pytest.approx(1.0)


def test_center_ray_points_at_target():
    # The center pixel's camera ray must pass (nearly) through `at`.
    c = cam.Camera()
    W = H = 101  # odd so the exact center pixel exists
    p2w = c.projection_to_world(aspect=1.0)
    px = jnp.asarray([[50]], dtype=jnp.int32)
    py = jnp.asarray([[50]], dtype=jnp.int32)
    o, d = cam.generate_camera_rays(px, py, W, H, tuple(c.eye) + (1.0,), p2w)
    o, d = np.asarray(o)[0, 0], np.asarray(d)[0, 0]
    to_at = np.asarray(c.at) - o
    cos = to_at @ d / np.linalg.norm(to_at)
    assert cos == pytest.approx(1.0, abs=1e-4)


def test_ray_direction_unit_norm():
    c = cam.Camera()
    p2w = c.projection_to_world(aspect=16 / 9)
    px, py = cam.pixel_grid(32, 18)
    _, d = cam.generate_camera_rays(px, py, 32, 18, tuple(c.eye) + (1.0,), p2w)
    norms = np.linalg.norm(np.asarray(d), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_y_flip_convention():
    # Smaller pixel_y (top of image) must give rays pointing more upward
    # (+y) than larger pixel_y — the DirectX screenPos.y = -y flip.
    c = cam.Camera()
    p2w = c.projection_to_world(aspect=1.0)
    px = jnp.asarray([0, 0], dtype=jnp.int32)
    py = jnp.asarray([0, 63], dtype=jnp.int32)
    _, d = cam.generate_camera_rays(px, py, 64, 64, tuple(c.eye) + (1.0,), p2w)
    d = np.asarray(d)
    assert d[0, 1] > d[1, 1]
