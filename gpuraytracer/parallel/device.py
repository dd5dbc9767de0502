"""Device selection — the DeviceResources adapter-enumeration analog.

The reference enumerates DXGI adapters preferring high-performance GPUs
with a WARP software-rasterizer fallback in debug builds
(DeviceResources.cpp:794-875). Here: prefer the GPU backend, fall back to
CPU (the software device, logged as such) so everything runs anywhere; an
explicit adapter override (DeviceResources.cpp:811-845) maps to
`device_index`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax

from gpuraytracer.utils.log import get_logger

log = get_logger("device")

PLATFORMS = ("gpu", "cpu")


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    device: Any
    platform: str  # "gpu" | "cpu"
    is_software: bool  # CPU fallback == the WARP analog
    description: str

    @property
    def id(self) -> int:
        return self.device.id


def available_platforms() -> list[str]:
    platforms = []
    for name in PLATFORMS:
        try:
            if jax.devices(name):
                platforms.append(name)
        except RuntimeError:
            pass
    return platforms


def pick_device(platform: str = "auto", device_index: int = 0) -> DeviceInfo:
    """platform: "auto" (prefer the GPU, fall back to CPU), "gpu", or "cpu".

    Raises RuntimeError if an explicitly requested platform is unavailable —
    the analog of the reference's hard assert on DXR support
    (Renderer.cpp:68). A CPU pick is logged as the software device.
    """
    order = PLATFORMS if platform == "auto" else (platform,)
    last_err: Optional[Exception] = None
    for name in order:
        try:
            devices = jax.devices(name)
        except RuntimeError as e:
            last_err = e
            continue
        if not devices:
            continue
        if device_index >= len(devices):
            raise RuntimeError(
                f"device_index {device_index} out of range for platform "
                f"{name!r} ({len(devices)} devices)"
            )
        dev = devices[device_index]
        info = DeviceInfo(
            device=dev,
            platform=name,
            is_software=(name == "cpu"),
            description=f"{dev.device_kind} (id {dev.id}, platform {name})",
        )
        if info.is_software:
            log.warning("rendering on the software device: %s", info.description)
        return info
    raise RuntimeError(f"no usable device for platform={platform!r}: {last_err}")
