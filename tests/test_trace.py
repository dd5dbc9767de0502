"""Full-scene wavefront integrator tests (CPU backend, small frames)."""

import jax
import numpy as np
import pytest

from gpuraytracer.core.types import BACKGROUND_COLOR
from gpuraytracer.models import builtin
from gpuraytracer.render import trace

W = H = 48


@pytest.fixture(scope="module")
def frame():
    scene = builtin.build_scene(aspect=W / H, elapsed_time=0.0)
    render = trace.make_renderer(scene.layout, W, H)
    return np.asarray(render(scene.arrays))


def test_image_finite(frame):
    assert frame.shape == (H, W, 4)
    assert np.isfinite(frame).all()


def test_sky_corners_are_background(frame):
    # Top corners look above the horizon -> miss shader background color.
    np.testing.assert_allclose(frame[0, 0], BACKGROUND_COLOR, atol=1e-6)
    np.testing.assert_allclose(frame[0, -1], BACKGROUND_COLOR, atol=1e-6)


def test_scene_content_present(frame):
    # A meaningful fraction of pixels differ from the background (geometry
    # + plane + shadows).
    bg = np.asarray(BACKGROUND_COLOR, dtype=np.float32)
    diff = np.abs(frame - bg).max(axis=-1)
    assert (diff > 1e-3).mean() > 0.3


def test_bottom_rows_hit_plane(frame):
    # The bottom of the frame looks down at the checkered plane: not
    # background, and roughly grey (checker * phong of 0.9 albedo).
    bg = np.asarray(BACKGROUND_COLOR, dtype=np.float32)
    bottom = frame[-1]
    assert (np.abs(bottom - bg).max(axis=-1) > 1e-3).mean() > 0.9


def test_shadows_darken_plane(frame):
    # In-shadow plane pixels get diffuse * 0.35; the image must contain
    # noticeably darker plane pixels than the brightest plane pixels.
    luma = frame[..., :3].mean(axis=-1)
    lower_half = luma[H // 2 :]
    assert lower_half.max() - lower_half.min() > 0.2


def test_animation_changes_image():
    scene0 = builtin.build_scene(aspect=1.0, elapsed_time=0.0)
    scene1 = builtin.build_scene(aspect=1.0, elapsed_time=1.0)
    render = trace.make_renderer(scene0.layout, 32, 32)
    a = np.asarray(render(scene0.arrays))
    b = np.asarray(render(scene1.arrays))
    assert not np.allclose(a, b)


def test_to_rgba8(frame):
    q = np.asarray(trace.to_rgba8(frame))
    assert q.dtype == np.uint8
    assert q.shape == frame.shape
    # Saturation: all values in range by construction; background maps to
    # (204, 230, 255, 255).
    np.testing.assert_array_equal(q[0, 0], [204, 230, 255, 255])
