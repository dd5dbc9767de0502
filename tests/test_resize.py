"""Live resize path (VERDICT round-1 item 5 / reference chain
Window.cpp:95-106 -> Renderer.cpp:150-161 -> output rebuild 1299-1304).

The Renderer listens to Viewport.on_size_changed and rebuilds its
size-dependent resources: the aspect-dependent camera constants and the
size-baked jitted frame program. A resized render must equal a renderer
BUILT at that size.
"""

import gc

import numpy as np

from gpuraytracer.render.renderer import Renderer
from gpuraytracer.utils.event import Viewport


def test_resize_rebuilds_and_matches_fresh_build():
    r = Renderer(64, 36)
    img_small = np.asarray(r.render(0.3))
    assert img_small.shape == (36, 64, 4)

    r.resize(96, 54)
    assert r.size == (96, 54)
    img_resized = np.asarray(r.render(0.3))
    assert img_resized.shape == (54, 96, 4)

    fresh = Renderer(96, 54)
    img_fresh = np.asarray(fresh.render(0.3))
    # The resized renderer's camera constants must be rebuilt for the new
    # aspect — identical program, identical output.
    np.testing.assert_array_equal(img_resized, img_fresh)


def test_noop_resize_keeps_program():
    r = Renderer(64, 36)
    step_before = r._step
    r.resize(64, 36)  # the reference also ignores no-op WM_SIZE
    assert r._step is step_before


def test_resize_listener_is_weak():
    """AK::Event parity: a dropped renderer must not leak a listener
    (Event.h auto-cleans expired weak refs)."""
    r = Renderer(32, 32)
    vp = r.viewport
    assert vp.on_size_changed.listener_count == 1
    del r
    gc.collect()
    # Dispatch cleans expired weak-method listeners.
    vp.resize(48, 48)
    assert vp.on_size_changed.listener_count == 0


def test_event_dispatches_new_size():
    seen = []
    vp = Viewport(10, 10)
    vp.on_size_changed.attach(lambda w, h: seen.append((w, h)))
    vp.resize(20, 30)
    vp.resize(20, 30)  # no-op: no dispatch
    assert seen == [(20, 30)]
    assert vp.aspect_ratio == 20 / 30
