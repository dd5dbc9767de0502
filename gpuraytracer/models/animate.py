"""Host-side per-frame animation state — the Renderer::on_update analog
(Renderer.cpp:82-120).

Camera orbit (48 s/rev), light orbit (-360deg / 8 s) and geometry-time
accumulation are CUMULATIVE updates driven by the frame delta time, exactly
like the reference (which rotates the stored eye/up/at and light position
in place each tick). Geometry animation is ON by default; camera/light
orbits are OFF (Renderer.cpp:46, Renderer.h:105-107).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from gpuraytracer.core.camera import Camera, rotation_y, transform_point_row
from gpuraytracer.core.config import RenderConfig
from gpuraytracer.models import builtin

CAMERA_SECONDS_PER_REV = 48.0  # Renderer.cpp:94
LIGHT_SECONDS_PER_REV = 8.0  # Renderer.cpp:106


@dataclasses.dataclass
class AnimationState:
    camera: Camera
    light_position: np.ndarray  # (4,)
    geometry_time: float = 0.0

    @classmethod
    def initial(cls) -> "AnimationState":
        return cls(
            camera=builtin.default_camera(),
            light_position=np.asarray(builtin.LIGHT_POSITION, dtype=np.float64),
        )

    def tick(self, delta_seconds: float, config: RenderConfig) -> "AnimationState":
        """Advance one frame by the elapsed delta (StepTimer tick analog)."""
        cam = self.camera
        light = self.light_position
        if config.animate_camera:
            angle = 2.0 * math.pi * (delta_seconds / CAMERA_SECONDS_PER_REV)
            cam = cam.rotate_y(angle)
        if config.animate_light:
            angle = -2.0 * math.pi * (delta_seconds / LIGHT_SECONDS_PER_REV)
            rot = rotation_y(angle)
            xyz = transform_point_row(light[:3], rot)
            light = np.asarray([xyz[0], xyz[1], xyz[2], light[3]])
        geo_t = self.geometry_time + (delta_seconds if config.animate_geometry else 0.0)
        return AnimationState(camera=cam, light_position=light, geometry_time=geo_t)

    def scene(self, aspect: float):
        """Build the Scene for the current state (elapsed_time feeds both the
        per-instance transforms and the metaball keyframes)."""
        return builtin.build_scene(
            aspect,
            elapsed_time=self.geometry_time,
            camera=self.camera,
            light_position=tuple(self.light_position),
        )
