"""Golden-image regression test (CPU backend — the WARP software device
analog, SURVEY.md §4).

The golden is a 96x54 render of the builtin scene at t=0.7 produced by the
XLA reference path on the CPU backend. Any change to intersector math,
shading order, scene constants, or traversal semantics shows up here; the
comparison budget matches the 1e-3 per-pixel radiance parity target with a
much tighter mean bound.
"""

import os

import numpy as np
import pytest

from gpuraytracer.models import builtin
from gpuraytracer.render import trace

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_builtin_96x54_t0p7.npz")
W, H = 96, 54


@pytest.fixture(scope="module")
def rendered():
    scene = builtin.build_scene(aspect=W / H, elapsed_time=0.7)
    render = trace.make_renderer(scene.layout, W, H)
    return np.asarray(render(scene.arrays))


def test_golden_exists():
    assert os.path.exists(GOLDEN_PATH), "golden missing — regenerate via tests/README"


def test_matches_golden(rendered):
    golden = np.load(GOLDEN_PATH)["image"]
    assert golden.shape == rendered.shape
    diff = np.abs(rendered - golden).max(axis=-1)
    # Same backend + same code => tight agreement; small slack for XLA
    # version / vectorization drift.
    assert diff.max() < 1e-3, f"max diff {diff.max()}"
    assert diff.mean() < 1e-5, f"mean diff {diff.mean()}"


def test_golden_has_scene_content():
    golden = np.load(GOLDEN_PATH)["image"]
    # Guard against a silently-empty golden (all background).
    bg = np.asarray([0.8, 0.9, 1.0, 1.0], dtype=np.float32)
    assert (np.abs(golden - bg).max(axis=-1) > 1e-3).mean() > 0.3
