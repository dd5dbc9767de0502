"""Scene traversal: closest-hit and any-hit (occlusion) queries.

This is the DispatchRays/TraceRay replacement: a static unroll over the
scene's 11 geometries, each gated by a vectorized slab test of its
BLAS-space AABB (the DXR driver's AABB gate analog), with per-geometry
intersection kernels and a global min-t reduction (DXR closest-hit-wins).

Shadow rays reuse the same kernels with any-valid-hit semantics — the
ACCEPT_FIRST_HIT_AND_END_SEARCH flag analog (Raytracing.hlsl:135-144);
for the procedural kernels "first accepted hit" and "any valid hit"
coincide because each kernel already returns its first valid hit along t.
"""

from __future__ import annotations

import jax.numpy as jnp

from gpuraytracer.accel.instances import (
    Scene,
    normal_to_world,
    ray_to_blas,
    ray_to_local,
)
from gpuraytracer.core.types import (
    HitRecord,
    IntersectorKind,
    RAY_TMAX,
    RAY_TMIN,
    AnalyticPrimitive,
)
from gpuraytracer.geometry import analytic, metaballs, sdf
from gpuraytracer.kernels import sdf_march


def intersect_plane(origins, directions, plane_origin, plane_size, *, t_min, t_max):
    """Ground-plane quad: two back-face-culled triangles tiling the rect
    y == plane_origin.y, x/z in [origin, origin + size]
    (Renderer.cpp:539-565 geometry x Renderer.cpp:742-765 instance
    transform). The two triangles tile the rectangle exactly, so the test is
    a rect test; normal is the flat vertex normal (0,1,0)
    (Raytracing.hlsl:171-195)."""
    dy = directions[..., 1]
    oy = origins[..., 1] - plane_origin[1]
    t = -oy / dy  # dy == 0 -> +-inf -> rejected by range test
    px = origins[..., 0] + t * directions[..., 0]
    pz = origins[..., 2] + t * directions[..., 2]
    inside = (
        (px >= plane_origin[0])
        & (px <= plane_origin[0] + plane_size[0])
        & (pz >= plane_origin[2])
        & (pz <= plane_origin[2] + plane_size[1])
    )
    # RAY_FLAG_CULL_BACK_FACING_TRIANGLES: rays from below (dir.y > 0 against
    # the up-facing winding) never hit.
    facing = dy < 0.0
    hit = inside & facing & (t >= t_min) & (t <= t_max)
    return hit, jnp.where(hit, t, jnp.inf)


def _dispatch_procedural(kind, prim_type, o_loc, d_loc, *, t_min, t_max, cull, step_scale, elapsed_time, gate, mesh=None, max_steps=None, occlusion=False, level=None):
    """Static dispatch to the intersection kernel for one geometry — the
    lax.switch-free SBT analog (each geometry's kernel is known at trace
    time; Raytracing.hlsl:289-341)."""
    if kind == IntersectorKind.TRIANGLE:
        # Generic indexed-triangle geometry (the triangle BLAS analog,
        # Renderer.cpp:575-592); prim_type indexed arrays.meshes upstream.
        from gpuraytracer.geometry import trimesh

        return trimesh.intersect_trimesh(
            o_loc, d_loc, mesh, t_min=t_min, t_max=t_max, cull_backface=cull
        )
    if kind == IntersectorKind.ANALYTIC:
        if prim_type == AnalyticPrimitive.AABB:
            return analytic.intersect_hollow_aabb(
                o_loc, d_loc, t_min=t_min, t_max=t_max, cull_backface=cull
            )
        elif prim_type == AnalyticPrimitive.SPHERES:
            return analytic.intersect_spheres(
                o_loc, d_loc, t_min=t_min, t_max=t_max, cull_backface=cull
            )
    elif kind == IntersectorKind.VOLUMETRIC:
        return metaballs.intersect_metaballs(
            o_loc,
            d_loc,
            elapsed_time,
            t_min=t_min,
            t_max=t_max,
            cull_backface=cull,
            active=gate,
        )
    elif kind == IntersectorKind.SIGNED_DISTANCE:
        # Extension DE fractals (codes >= 7) skip back-face culling and are
        # DEFINED clipped to their unit AABB: the march window is
        # [max(entry, t_min), min(exit, t_max)], so empty space before the
        # box and miss lanes beyond it cost nothing. The ray parameter t is
        # shared between spaces (ray_to_local preserves it), so the local
        # [-1,1]^3 slab interval is the window. Reference primitives march
        # from t=0 to RayTCurrent for parity.
        t_lo = None
        t_hi = t_max
        if int(prim_type) >= 7:
            cull = False
            w_lo, w_hi = analytic.aabb_interval(
                o_loc, d_loc, (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)
            )
            t_lo = jnp.maximum(w_lo, t_min)
            t_hi = jnp.minimum(
                jnp.asarray(t_max, dtype=o_loc.dtype), w_hi
            )
            gate = gate & (w_hi > w_lo) & (t_hi > t_lo)
        from gpuraytracer.core.types import SDF_MAX_STEPS

        natural = SDF_MAX_STEPS if max_steps is None else int(max_steps)
        steps = natural
        # Extension DE fractals march over-relaxed (Keinert 2014 —
        # sdf.extension_relax); reference codes keep the exact reference
        # step sequence (relax = 1) unless GPURT_RELAX_REF opts in, and
        # occlusion queries honor GPURT_RELAX_SHADOW (sdf.occlusion_relax).
        relax = sdf.relax_for_code(int(prim_type), occlusion=occlusion)
        if occlusion:
            steps = sdf.cap_occlusion_budget(steps)
            steps_b = sdf.cap_occlusion_budget(steps, bounce=True)
        else:
            steps = sdf.cap_radiance_budget(steps)
            steps_b = sdf.cap_radiance_budget(steps, bounce=True)
        # Per-LEVEL budget: bounce-level marches cap harder. The budget is
        # comparison-only inside both marchers, so a traced level selects
        # it by value.
        if level is not None and steps_b < steps:
            if isinstance(level, int):
                steps_eff = steps if level == 0 else steps_b
            else:
                steps_eff = jnp.where(level == 0, jnp.int32(steps),
                                      jnp.int32(steps_b))
        else:
            steps_eff = steps
        # Conservative occlusion on budget exhaustion (closest=>occluded
        # invariant, tests/test_properties.py): a capped occlusion march
        # has not proven light visibility, so it reports occluded. Only
        # reduced budgets trigger it — with the caps off (knobs 0) the
        # full-budget march keeps the reference's miss-on-exhaustion
        # semantics exactly (SignedDistancePrimitives.hlsli:291-317).
        capped_hit = False
        if occlusion:
            if isinstance(steps_eff, int):
                capped_hit = steps_eff < natural
            else:
                capped_hit = steps_eff < jnp.int32(natural)
        t_start = t_min if t_lo is None else t_lo
        # The retirement bound only holds for envelope-verified codes;
        # extension primitives are AABB-windowed instead (t_hi above).
        escape_bound = int(prim_type) in sdf.ESCAPE_SAFE_CODES
        if sdf_march.kernel_available(int(prim_type)):
            # On the GPU each block of rays marches in registers and exits
            # on its own slowest ray (kernels/sdf_march.py); the XLA march
            # below is the portable reference.
            return sdf_march.sphere_trace_lanes(
                o_loc, d_loc, gate, t_start, t_hi, step_scale, steps_eff,
                capped_hit, prim_code=int(prim_type), cull_backface=cull,
                escape_bound=escape_bound, relax=relax,
            )
        return sdf.sphere_trace(
            o_loc,
            d_loc,
            sdf.DISTANCE_FUNCTIONS[int(prim_type)],
            step_scale=step_scale,
            t_min=t_start,
            t_max=t_hi,
            cull_backface=cull,
            active=gate,
            max_steps=steps_eff,
            escape_bound=escape_bound,
            relax=relax,
            capped_hit=capped_hit,
        )
    raise ValueError(f"no intersector for kind={kind} type={prim_type}")


def closest_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX, cull_backface=True, active=None, level=None) -> HitRecord:
    """Global closest hit over plane + all procedural geometries.

    Returns world-space HitRecord; geometry_id indexes the material table
    (procedural 0..P-1, plane == P, miss == -1).
    """
    layout, arrays = scene.layout, scene.arrays
    batch = origins.shape[:-1]
    f32 = origins.dtype

    if active is None:
        active = jnp.ones(batch, dtype=bool)

    best_t = jnp.full(batch, jnp.inf, dtype=f32)
    best_n = jnp.zeros(origins.shape, dtype=f32)
    best_id = jnp.full(batch, -1, dtype=jnp.int32)

    # --- plane ---
    if layout.has_plane:
        hit_p, t_p = intersect_plane(
            origins, directions, arrays.plane_origin, arrays.plane_size,
            t_min=t_min, t_max=t_max,
        )
        hit_p = hit_p & active
        best_t = jnp.where(hit_p, t_p, best_t)
        up = jnp.zeros_like(origins).at[..., 1].set(1.0)
        best_n = jnp.where(hit_p[..., None], up, best_n)
        best_id = jnp.where(hit_p, layout.plane_geometry_id, best_id)

    # --- procedural instances (static unroll; P == 10 for the builtin scene) ---
    # Each geometry sees t_max shrunk to the best hit found so far — the
    # DXR RayTCurrent-shrinks-during-traversal behavior. Closest-hit-wins is
    # order independent, so the final image is identical to independent
    # full-range tests; the marchers just escape (t > RayTCurrent) orders of
    # magnitude sooner once the plane (tested first) bounds t.
    o_blas, d_blas = ray_to_blas(origins, directions, arrays.blas_offset)
    for i, (kind, prim_type) in enumerate(zip(layout.kinds, layout.prim_types)):
        running_t_max = jnp.minimum(t_max, best_t)
        gate = analytic.aabb_hit_mask(
            o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
            t_min=t_min, t_max=running_t_max,
        ) & active
        o_loc, d_loc = ray_to_local(o_blas, d_blas, arrays.transforms.blas_to_local[i])
        hit_i, t_i, n_loc = _dispatch_procedural(
            kind,
            prim_type,
            o_loc,
            d_loc,
            t_min=t_min,
            t_max=running_t_max,
            cull=cull_backface,
            step_scale=arrays.materials.step_scale[i],
            elapsed_time=arrays.constants.elapsed_time,
            gate=gate,
            mesh=arrays.meshes[prim_type] if kind == IntersectorKind.TRIANGLE else None,
            max_steps=layout.step_budgets[i] if layout.step_budgets else None,
            level=level,
        )
        hit_i = hit_i & gate
        closer = hit_i & (t_i < best_t)
        n_world = normal_to_world(n_loc, arrays.transforms.local_to_blas[i])
        best_t = jnp.where(closer, t_i, best_t)
        best_n = jnp.where(closer[..., None], n_world, best_n)
        best_id = jnp.where(closer, i, best_id)

    hit = best_id >= 0
    return HitRecord(
        t=jnp.where(hit, best_t, RAY_TMAX),
        normal=best_n,
        geometry_id=best_id,
        hit=hit,
    )


def any_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX, active=None, level=None):
    """Occlusion query — the shadow-ray TraceRay with
    ACCEPT_FIRST_HIT | FORCE_OPAQUE | SKIP_CLOSEST_HIT flags
    (Raytracing.hlsl:115-147). Back-face culling stays ON (the flag is set
    on shadow rays too), which is what prevents surface self-shadowing.

    Returns a boolean occlusion mask."""
    layout, arrays = scene.layout, scene.arrays
    batch = origins.shape[:-1]
    if active is None:
        active = jnp.ones(batch, dtype=bool)

    occluded = jnp.zeros(batch, dtype=bool)

    if layout.has_plane:
        hit_p, _ = intersect_plane(
            origins, directions, arrays.plane_origin, arrays.plane_size,
            t_min=t_min, t_max=t_max,
        )
        occluded = occluded | (hit_p & active)

    o_blas, d_blas = ray_to_blas(origins, directions, arrays.blas_offset)
    for i, (kind, prim_type) in enumerate(zip(layout.kinds, layout.prim_types)):
        remaining = active & ~occluded
        gate = analytic.aabb_hit_mask(
            o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
            t_min=t_min, t_max=t_max,
        ) & remaining
        o_loc, d_loc = ray_to_local(o_blas, d_blas, arrays.transforms.blas_to_local[i])
        hit_i, _, _ = _dispatch_procedural(
            kind,
            prim_type,
            o_loc,
            d_loc,
            t_min=t_min,
            t_max=t_max,
            cull=True,
            step_scale=arrays.materials.step_scale[i],
            elapsed_time=arrays.constants.elapsed_time,
            gate=gate,
            mesh=arrays.meshes[prim_type] if kind == IntersectorKind.TRIANGLE else None,
            max_steps=layout.step_budgets[i] if layout.step_budgets else None,
            occlusion=True,
            level=level,
        )
        occluded = occluded | (hit_i & gate)

    return occluded
