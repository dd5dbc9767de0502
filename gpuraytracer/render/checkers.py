"""Analytically box-filtered checkerboard texture with ray differentials.

Reproduces:
  CheckersTextureBoxFilter       SignedDistancePrimitives.hlsli:324-334
  CalculateRayDifferentials      RaytracingShaderHelper.hlsli:148-161
  AnalyticalCheckersTexture      RaytracingShaderHelper.hlsli:167-175

The ray differentials come from the CAMERA rays of the neighboring pixels
(DispatchRaysIndex + (1,0)/(0,1)) intersected with the hit's tangent plane —
even for reflection rays hitting the plane, exactly as the reference does
(DispatchRaysIndex is the launch index, not the bounce ray's pixel).
"""

from __future__ import annotations

import jax.numpy as jnp

from gpuraytracer.core import camera as cam
from gpuraytracer.core import hlsl

CHECKERS_RATIO = 50  # center-fill to border ratio (hlsli call site :174)


def checkers_box_filter(uv, dpdx, dpdy, ratio=CHECKERS_RATIO):
    """Analytical integral of the checker grid over the filter kernel
    (SignedDistancePrimitives.hlsli:324-334)."""
    w = jnp.maximum(jnp.abs(dpdx), jnp.abs(dpdy))
    a = uv + 0.5 * w
    b = uv - 0.5 * w
    i = (
        jnp.floor(a)
        + jnp.minimum(hlsl.frac(a) * ratio, 1.0)
        - jnp.floor(b)
        - jnp.minimum(hlsl.frac(b) * ratio, 1.0)
    ) / (ratio * w)
    return (1.0 - i[..., 0]) * (1.0 - i[..., 1])


def analytical_checkers(
    hit_position,  # (..., 3)
    surface_normal,  # (..., 3)
    pixel_x,  # (...,) launch-index x
    pixel_y,  # (...,) launch-index y
    width,
    height,
    camera_position,  # (4,) or (3,)
    projection_to_world,  # (4, 4) row-vector convention
):
    """AnalyticalCheckersTexture: uv = hit.xz, differentials from
    neighbor-pixel camera rays intersected with the tangent plane."""
    uv = jnp.stack([hit_position[..., 0], hit_position[..., 2]], axis=-1)

    ox, dx_dir = cam.generate_camera_rays(
        pixel_x + 1, pixel_y, width, height, camera_position, projection_to_world
    )
    oy, dy_dir = cam.generate_camera_rays(
        pixel_x, pixel_y + 1, width, height, camera_position, projection_to_world
    )

    def plane_project(o, d):
        # o - d * dot(o - hit, N) / dot(d, N)  (hlsli:155-156)
        num = hlsl.dot(o - hit_position, surface_normal, keepdims=True)
        den = hlsl.dot(d, surface_normal, keepdims=True)
        return o - d * (num / den)

    px_pos = plane_project(ox, dx_dir)
    ddx_uv = jnp.stack([px_pos[..., 0], px_pos[..., 2]], axis=-1) - uv
    py_pos = plane_project(oy, dy_dir)
    ddy_uv = jnp.stack([py_pos[..., 0], py_pos[..., 2]], axis=-1) - uv
    return checkers_box_filter(uv, ddx_uv, ddy_uv, CHECKERS_RATIO)
