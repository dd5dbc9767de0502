"""Render configuration.

The reference has no config system — everything is a compile-time constant
(SURVEY.md §5 "Config / flag system: None"): resolution hard-coded 1280x720
(main.cpp:14), animation toggles ctor-set bools (Renderer.cpp:46,
Renderer.h:105-107). This dataclass is the deliberate improvement called out
there; its defaults equal the reference constants.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280  # main.cpp:14
    height: int = 720
    max_recursion_depth: int = 3  # ConstantBuffers.h:31
    animate_geometry: bool = True  # Renderer.cpp:46
    animate_camera: bool = False  # Renderer.h:106
    animate_light: bool = False  # Renderer.h:107
    # Device/backend: "auto" prefers the GPU with a logged CPU fallback (the
    # WARP analog, DeviceResources.cpp:848-860); "gpu" requires one, "cpu"
    # forces the software backend.
    platform: str = "auto"
    # Frames in flight for the async render pipeline (Renderer.h:92).
    frames_in_flight: int = 3
    # Output dtype for the framebuffer: "float32" (radiance) or "rgba8"
    # (the R8G8B8A8_UNORM backbuffer analog).
    output_format: str = "float32"

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def with_size(self, width: int, height: int) -> "RenderConfig":
        return dataclasses.replace(self, width=width, height=height)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
