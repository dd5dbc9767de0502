"""Shading: Phong + fake AO, Fresnel-Schlick, distance fog.

Reproduces the shading math of src/Raytracing.hlsl:
  CalculateDiffuseCoefficient / Specular  :35-46
  CalculatePhongLighting (+ fake AO)      :50-80
  FresnelReflectanceSchlick               RaytracingShaderHelper.hlsli:178-182
  distance-fog falloff                    Raytracing.hlsl:213-215, 248-250
All inputs are wavefront arrays; colors are float4 (alpha carried for ABI
parity with the reference's float4 payloads).
"""

from __future__ import annotations

import jax.numpy as jnp

from gpuraytracer.core import hlsl
from gpuraytracer.core.types import BACKGROUND_COLOR, IN_SHADOW_RADIANCE


def phong_lighting(
    albedo,  # (..., 4)
    normal,  # (..., 3)
    in_shadow,  # (...,) bool
    hit_position,  # (..., 3)
    ray_direction,  # (..., 3) incoming WorldRayDirection
    light_position,  # (3,) or (..., 3)
    light_ambient_color,  # (4,)
    light_diffuse_color,  # (4,)
    diffuse_coef,  # (...,)
    specular_coef,  # (...,)
    specular_power,  # (...,)
):
    """CalculatePhongLighting (Raytracing.hlsl:50-80)."""
    shadow_factor = jnp.where(in_shadow, IN_SHADOW_RADIANCE, 1.0)
    incident = hlsl.normalize(hit_position - light_position)

    # Diffuse: saturate(dot(-L, N)).
    kd = hlsl.saturate(hlsl.dot(-incident, normal))
    diffuse = (
        (shadow_factor * diffuse_coef * kd)[..., None] * light_diffuse_color * albedo
    )

    # Specular: (R.V)^power with white light, zeroed in shadow (hlsl:63-69).
    reflected_light = hlsl.normalize(hlsl.reflect(incident, normal))
    ks = jnp.power(
        hlsl.saturate(hlsl.dot(reflected_light, hlsl.normalize(-ray_direction))),
        specular_power,
    )
    specular = jnp.where(
        in_shadow[..., None], 0.0, (specular_coef * ks)[..., None] * jnp.ones(4, dtype=albedo.dtype)
    )

    # Ambient with fake AO: darken faces pointing away from the sky
    # (hlsl:72-77): lerp(ambient - 0.1, ambient, 1 - saturate(dot(N, -Y))).
    a = 1.0 - hlsl.saturate(hlsl.dot(normal, jnp.asarray([0.0, -1.0, 0.0], dtype=normal.dtype)))
    ambient = albedo * hlsl.lerp(
        light_ambient_color - 0.1, light_ambient_color, a[..., None]
    )

    return ambient + diffuse + specular


def fresnel_reflectance_schlick(incident, normal, f0):
    """FresnelReflectanceSchlick (RaytracingShaderHelper.hlsli:178-182):
    f0 + (1 - f0) * (1 - saturate(dot(-I, N)))^5. f0 is the material albedo
    rgb (Raytracing.hlsl:205, 240)."""
    cosi = hlsl.saturate(hlsl.dot(-incident, normal, keepdims=True))
    return f0 + (1.0 - f0) * jnp.power(1.0 - cosi, 5.0)


def fog_factor(t):
    """Visibility falloff weight toward the background:
    1 - exp(-0.000002 * t^3) (Raytracing.hlsl:213-215)."""
    return 1.0 - jnp.exp(-0.000002 * t * t * t)


def background_color(dtype=jnp.float32):
    return jnp.asarray(BACKGROUND_COLOR, dtype=dtype)
