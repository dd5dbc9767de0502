"""Wavefront integrator — the TraceRay recursion unrolled to depth 3.

The DXR execution model shades INSIDE the hit of the parent ray
(Raytracing.hlsl:171-253, recursion via TraceRadianceRay :87-112). Here the
recursion is restructured as a linear recurrence over bounce levels: every
closest-hit color is affine in the color returned by its reflection child,

    c_d = base_d + M_d * c_{d+1}
    base_d = (1 - fog_d) * checkers_d * phong_d + fog_d * BACKGROUND
    M_d    = (1 - fog_d) * checkers_d * reflectance * float4(fresnel, 1)

(with checkers == 1 for procedural hits, base == BACKGROUND and M == 0 on
miss, and M == 0 at the recursion cap), so

    c_0 = sum_d (prod_{j<d} M_j) * base_d

which the loop below accumulates with a running throughput product. The
reassociation only reorders float multiplies (~1 ulp), far inside the 1e-3
radiance tolerance.

Depth accounting matches the reference exactly (ConstantBuffers.h:31,
Raytracing.hlsl:89-91,117-120,193,203): three shading levels; shadow rays
are traced at levels 0 and 1 only — at level 2 the shadow trace hits the
recursion cap and returns "not in shadow".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpuraytracer.accel.instances import Scene
from gpuraytracer.accel.traverse import any_hit, closest_hit
from gpuraytracer.core import camera as cam
from gpuraytracer.core import hlsl
from gpuraytracer.core.types import (
    MAX_RAY_RECURSION_DEPTH,
    RAY_TMAX,
    RAY_TMIN,
    REFLECTANCE_EPS,
)
from gpuraytracer.render import checkers as checkers_mod
from gpuraytracer.render import shade


def _gather_materials(materials, geometry_id, material_ids=None):
    """Index the material SoA by per-ray geometry id (the shader-record
    local-root-argument fetch analog). Miss lanes are clamped to row 0 and
    masked by callers.

    For the small tables of this workload (11 rows) a branchless select
    chain replaces per-ray gathers. With a deduped table (SceneLayout.material_ids) the
    geometry id is first mapped to its unique material slot by a static
    int select chain (identity entries skipped), then the field chain runs
    over UNIQUE rows only."""
    g = materials.albedo.shape[0]
    if material_ids is not None:
        mid = jnp.zeros_like(geometry_id)
        for gidx, slot in enumerate(material_ids):
            if slot != 0:
                mid = jnp.where(geometry_id == gidx, slot, mid)
        geometry_id = mid
    if g <= 16:
        def pick(table):
            out = jnp.broadcast_to(
                table[0], geometry_id.shape + table.shape[1:]
            ).astype(table.dtype)
            for i in range(1, g):
                m = geometry_id == i
                if table.ndim > 1:
                    m = m[..., None]
                out = jnp.where(m, table[i], out)
            return out

        return (
            pick(materials.albedo),
            pick(materials.reflectance_coefficient),
            pick(materials.diffuse_coefficient),
            pick(materials.specular_coefficient),
            pick(materials.specular_power),
        )
    idx = jnp.clip(geometry_id, 0, g - 1)
    return (
        materials.albedo[idx],
        materials.reflectance_coefficient[idx],
        materials.diffuse_coefficient[idx],
        materials.specular_coefficient[idx],
        materials.specular_power[idx],
    )


def trace_radiance(
    origins,
    directions,
    pixel_x,
    pixel_y,
    width,
    height,
    scene: Scene,
    *,
    max_depth: int = MAX_RAY_RECURSION_DEPTH,
):
    """Trace a radiance wavefront and return float4 colors, shape (..., 4).

    pixel_x/pixel_y are the launch indices (DispatchRaysIndex analog),
    needed for the plane's checkerboard ray differentials at every bounce.
    """
    arrays = scene.arrays
    constants = arrays.constants
    batch = origins.shape[:-1]
    f32 = origins.dtype

    bg = shade.background_color(f32)
    light_pos = constants.light_position[:3]
    plane_id = scene.layout.plane_geometry_id

    # Varying-by-construction scan carries (see sdf.sphere_trace): inherit
    # the rays' varying-manual-axes type so shard_map accepts the loop.
    vzero = (origins[..., :1] + directions[..., :1]) * 0.0  # (..., 1)
    color0 = jnp.zeros(batch + (4,), dtype=f32) + vzero
    throughput0 = jnp.ones(batch + (4,), dtype=f32) + vzero
    active0 = vzero[..., 0] > -1.0

    def level_body(carry, xs):
        trace_shadow, level = xs
        o, d, active, throughput, color = carry
        hit = closest_hit(o, d, scene, t_min=RAY_TMIN, t_max=RAY_TMAX,
                          cull_backface=True, active=active, level=level)
        hit_pos = o + hit.t[..., None] * d

        albedo, refl_coef, diff_coef, spec_coef, spec_pow = _gather_materials(
            arrays.materials, hit.geometry_id, scene.layout.material_ids
        )

        # Shadow ray. At the last level the reference's shadow trace hits the
        # recursion cap and short-circuits to "not occluded"
        # (Raytracing.hlsl:117-120); trace_shadow carries that flag, and the
        # dead pass costs nothing at runtime — an all-false active mask makes
        # every marcher's while_loop exit immediately.
        shadow_dir = hlsl.normalize(light_pos - hit_pos)
        in_shadow = any_hit(
            hit_pos, shadow_dir, scene,
            t_min=RAY_TMIN, t_max=RAY_TMAX,
            active=active & hit.hit & trace_shadow,
            level=level,
        )
        in_shadow = in_shadow & trace_shadow

        phong = shade.phong_lighting(
            albedo,
            hit.normal,
            in_shadow,
            hit_pos,
            d,
            light_pos,
            constants.light_ambient_color,
            constants.light_diffuse_color,
            diff_coef,
            spec_coef,
            spec_pow,
        )

        # Checkerboard modulation on plane hits only (Raytracing.hlsl:195,211).
        is_plane = hit.geometry_id == plane_id
        checkers = checkers_mod.analytical_checkers(
            hit_pos, hit.normal, pixel_x, pixel_y, width, height,
            constants.camera_position, constants.projection_to_world,
        )
        k = jnp.where(is_plane, checkers, 1.0)[..., None]

        # Reflection multiplier: reflectance * float4(fresnel(albedo.rgb), 1)
        # gated on reflectance > 0.001 (Raytracing.hlsl:198-207, 233-242).
        fresnel = shade.fresnel_reflectance_schlick(d, hit.normal, albedo[..., :3])
        refl_mult = refl_coef[..., None] * jnp.concatenate(
            [fresnel, jnp.ones(batch + (1,), dtype=f32)], axis=-1
        )
        reflective = hit.hit & (refl_coef > REFLECTANCE_EPS)
        refl_mult = jnp.where(reflective[..., None], refl_mult, 0.0)

        # Distance fog toward the background (Raytracing.hlsl:213-215).
        fog = shade.fog_factor(hit.t)[..., None]
        base = jnp.where(
            hit.hit[..., None],
            (1.0 - fog) * (k * phong) + fog * bg,
            bg,  # miss shader (Raytracing.hlsl:259-264)
        )
        mult = jnp.where(hit.hit[..., None], (1.0 - fog) * k * refl_mult, 0.0)

        color = color + jnp.where(active[..., None], throughput * base, 0.0)
        throughput = throughput * mult
        active = active & reflective
        o = hit_pos
        d = hlsl.reflect(d, hit.normal)
        return (o, d, active, throughput, color), None

    # Levels differ only in the shadow flag and the traced level index
    # (which selects the per-level march budget by VALUE — see
    # sdf.bounce_*_budget_cap); lax.scan compiles the traversal ONCE
    # instead of once per level (the depth-3 unroll would triple compile
    # time for identical code).
    shadow_flags = jnp.arange(max_depth) + 1 < max_depth
    (_, _, _, _, color), _ = jax.lax.scan(
        level_body,
        (origins, directions, active0, throughput0, color0),
        (shadow_flags, jnp.arange(max_depth, dtype=jnp.int32)),
    )
    return color


def render_frame(scene: Scene, width: int, height: int, *, max_depth: int = MAX_RAY_RECURSION_DEPTH):
    """Full-frame render: the DispatchRays(W, H, 1) analog
    (Renderer.cpp:401-452). Returns an (H, W, 4) float32 radiance image.

    The same wavefront path runs on every backend; on the CPU it is the
    portable reference (the WARP analog)."""
    px, py = cam.pixel_grid(width, height)
    origins, directions = cam.generate_camera_rays(
        px, py, width, height,
        scene.arrays.constants.camera_position,
        scene.arrays.constants.projection_to_world,
    )
    return trace_radiance(
        origins, directions, px, py, width, height, scene, max_depth=max_depth
    )


def make_renderer(layout, width: int, height: int, *, max_depth: int = MAX_RAY_RECURSION_DEPTH, donate: bool = False):
    """jit-compiled frame function over the traced scene arrays; layout is
    baked in (static dispatch — the compiled RTPSO analog)."""

    def _render(arrays):
        return render_frame(Scene(layout, arrays), width, height, max_depth=max_depth)

    return jax.jit(_render)


def to_rgba8(image_f32):
    """R8G8B8A8_UNORM conversion — the typed-UAV store the reference's
    output texture performs (saturate + round-to-nearest-even quantize)."""
    return jnp.round(jnp.clip(image_f32, 0.0, 1.0) * 255.0).astype(jnp.uint8)
