"""Renderer orchestration: viewport + scene + size-dependent resources.

The reference chain (WM_SIZE -> Window.on_size_changed event ->
Renderer::on_size_changed, /root/reference/src/Window.cpp:95-106 ->
Renderer.cpp:150-161) releases and recreates the window-size-dependent
resources: the output UAV (Renderer.cpp:1299-1304) and the camera
matrices (aspect-dependent, Renderer.cpp:1404-1407).

The equivalents here of "size-dependent resources": the jitted frame program
(shapes are baked into the compiled executable) and the aspect-dependent
projection_to_world constants. A resize therefore rebuilds the scene
constants and swaps in a differently-shaped jit — the recompile is the
swapchain ResizeBuffers analog. Attached through utils.event.Event with
the same weak-listener semantics as AK::Event.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax

from gpuraytracer.accel.instances import Scene
from gpuraytracer.core.types import MAX_RAY_RECURSION_DEPTH
from gpuraytracer.utils.event import Viewport
from gpuraytracer.utils.log import get_logger

log = get_logger("renderer")


class Renderer:
    """Owns a Viewport and the compiled frame step; listens to resize."""

    def __init__(
        self,
        width: int,
        height: int,
        scene_factory: Optional[Callable] = None,
        animate: Optional[Callable] = None,
        max_depth: int = MAX_RAY_RECURSION_DEPTH,
    ):
        from gpuraytracer.models import builtin

        self._factory = scene_factory or builtin.build_scene
        self._animate = animate if animate is not None else builtin.animate_arrays
        self._max_depth = max_depth
        self.viewport = Viewport(width, height)
        # Weak-method listener: a dropped Renderer detaches automatically,
        # like AK::Event's expired-weak_ptr cleanup (AK/Event.h:69-96).
        self.viewport.on_size_changed.attach(self.on_size_changed)
        self._create_size_dependent_resources()

    # -- size-dependent resources (Renderer.cpp:150-161 analog) ----------

    def _create_size_dependent_resources(self) -> None:
        from gpuraytracer.render import trace

        w, h = self.viewport.width, self.viewport.height
        scene = self._factory(aspect=w / h, elapsed_time=0.0)
        self._layout = scene.layout
        self._arrays = scene.arrays
        layout, depth, animate = self._layout, self._max_depth, self._animate

        def step(arrays, t):
            if animate is not False:
                arrays = animate(arrays, t)
            return trace.render_frame(Scene(layout, arrays), w, h, max_depth=depth)

        self._step = jax.jit(step)

    def on_size_changed(self, width: int, height: int) -> None:
        """Event target: the Viewport already carries the new size; rebuild
        the aspect-dependent constants + the compiled frame program."""
        log.info("resize -> %dx%d (rebuilding size-dependent resources)",
                 width, height)
        self._create_size_dependent_resources()

    def resize(self, width: int, height: int) -> None:
        """Programmatic resize (the ResizeBuffers entry): no-op sizes are
        ignored by the viewport, real changes dispatch on_size_changed."""
        self.viewport.resize(width, height)

    # -- frame step -------------------------------------------------------

    def render(self, elapsed_time: float = 0.0):
        """One frame at the current size; returns the (H, W, 4) radiance
        image (device array — call np.asarray for host access)."""
        return self._step(self._arrays, elapsed_time)

    @property
    def size(self):
        return self.viewport.width, self.viewport.height
