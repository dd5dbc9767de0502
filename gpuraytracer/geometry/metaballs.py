"""Animated metaballs ("blobs") — volumetric isosurface ray march.

Reproduces src/VolumetricPrimitives.hlsli:
  quintic falloff potential            :36-57
  summed potential + central-diff normal :60-86
  keyframed 3-ball animation (12 s cycle) :88-120
  bounding-sphere interval clipping     :124-147
  fixed 128-step march to the 0.25 isosurface :151-202

The per-thread while loop becomes a chunked early-exiting while loop over
the wavefront (two-phase pause/check, see sdf.sphere_trace); the march
interval [tmin, tmax] is per-ray.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpuraytracer.core import hlsl
from gpuraytracer.core.types import (
    METABALL_CYCLE_DURATION,
    METABALL_ISO_THRESHOLD,
    METABALL_MAX_STEPS,
    METABALLS_COUNT,
)

# Keyframe centers at t0/t1 and field radii for the 3-ball configuration
# (VolumetricPrimitives.hlsli:103-110).
KEYFRAME_CENTERS = (
    ((-0.3, -0.3, -0.4), (0.3, -0.3, -0.0)),
    ((0.0, -0.2, 0.5), (0.0, 0.4, 0.5)),
    ((0.4, 0.4, 0.4), (-0.4, 0.2, -0.4)),
)
RADII = (0.45, 0.55, 0.45)


def animated_metaballs(elapsed_time, cycle_duration=METABALL_CYCLE_DURATION):
    """Returns (centers (3,3), radii (3,)) lerped by the smoothstepped
    triangle-wave interpolant (hlsli:88-120)."""
    t = hlsl.calculate_animation_interpolant(elapsed_time, cycle_duration)
    c0 = jnp.asarray([k[0] for k in KEYFRAME_CENTERS], dtype=jnp.float32)
    c1 = jnp.asarray([k[1] for k in KEYFRAME_CENTERS], dtype=jnp.float32)
    centers = hlsl.lerp(c0, c1, t)
    radii = jnp.asarray(RADII, dtype=jnp.float32)
    return centers, radii


def metaball_potential(position, center, radius):
    """Quintic polynomial field 6d^5 - 15d^4 + 10d^3 over d = (r - dist)/r,
    zero outside the bounding radius (hlsli:36-57)."""
    distance = hlsl.length(position - center)
    d = radius - distance
    r = radius
    dr = d / r
    val = 6.0 * dr**5 - 15.0 * dr**4 + 10.0 * dr**3
    return jnp.where(distance <= radius, val, 0.0)


def metaballs_potential(position, centers, radii):
    """Sum of all METABALLS_COUNT potentials (hlsli:60-73)."""
    total = jnp.zeros(position.shape[:-1], dtype=position.dtype)
    for j in range(METABALLS_COUNT):
        total = total + metaball_potential(position, centers[j], radii[j])
    return total


def metaballs_normal(position, centers, radii):
    """Central differences of the summed potential, e = 0.5773e-5
    (hlsli:76-86). Note the sign: potential DEcreases outward, and the
    reference takes f(p-e) - f(p+e), which points outward."""
    e = 0.5773 * 0.00001

    def pot(p):
        return metaballs_potential(p, centers, radii)

    ex = jnp.asarray([e, 0.0, 0.0], dtype=position.dtype)
    ey = jnp.asarray([0.0, e, 0.0], dtype=position.dtype)
    ez = jnp.asarray([0.0, 0.0, e], dtype=position.dtype)
    n = hlsl.vec3(
        pot(position - ex) - pot(position + ex),
        pot(position - ey) - pot(position + ey),
        pot(position - ez) - pot(position + ez),
    )
    return hlsl.normalize(n)


def _solve_sphere(origins, directions, center, radius):
    """SolveRaySphereIntersectionEquation (AnalyticPrimitives.hlsli:54-60),
    returning (has_roots, t0, t1) with t0 <= t1."""
    L = origins - center
    a = hlsl.dot(directions, directions)
    b = 2.0 * hlsl.dot(directions, L)
    c = hlsl.dot(L, L) - radius * radius
    discr = b * b - 4.0 * a * c
    has = discr >= 0.0
    sq = jnp.sqrt(jnp.maximum(discr, 0.0))
    q = jnp.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    x0 = q / a
    x1 = c / q
    t0 = jnp.minimum(x0, x1)
    t1 = jnp.maximum(x0, x1)
    # discr == 0 branch of SolveQuadraticEqn: both roots -0.5*b/a.
    mid = -0.5 * b / a
    t0 = jnp.where(discr == 0.0, mid, t0)
    t1 = jnp.where(discr == 0.0, mid, t1)
    return has, t0, t1


def find_intersecting_metaballs(origins, directions, centers, radii, t_min, t_max):
    """Union of [entry, exit] over all metaball bounding spheres, clipped to
    the ray extents (hlsli:124-147 with LIMIT_TO_ACTIVE_METABALLS == 0).

    RaySolidSphereIntersectionTest clips per-sphere to [RayTMin, RayTCurrent]
    BEFORE the union (AnalyticPrimitives.hlsli:104-116)."""
    batch = origins.shape[:-1]
    f32 = origins.dtype
    tmin = jnp.full(batch, jnp.inf, dtype=f32)
    tmax = jnp.full(batch, -jnp.inf, dtype=f32)
    for j in range(METABALLS_COUNT):
        has, t0, t1 = _solve_sphere(origins, directions, centers[j], radii[j])
        thit_j = jnp.maximum(t0, t_min)
        tmax_j = jnp.minimum(t1, t_max)
        tmin = jnp.where(has, jnp.minimum(thit_j, tmin), tmin)
        tmax = jnp.where(has, jnp.maximum(tmax_j, tmax), tmax)
    tmin = jnp.maximum(tmin, t_min)
    tmax = jnp.minimum(tmax, t_max)
    return tmin, tmax


def intersect_metaballs(
    origins,
    directions,
    elapsed_time,
    *,
    t_min=0.0,
    t_max,
    cull_backface,
    active=None,
    max_steps: int = METABALL_MAX_STEPS,
    chunk_size: int | None = None,
    unroll: int | None = None,
):
    """RayMetaballsIntersectionTest (hlsli:151-202), wavefront form.

    origins/directions in the primitive's local space; t shared with world
    (see accel/instances.py). Returns (hit, t_hit, normal).

    Chunked early-exiting two-phase while loop (same structure as
    sdf.sphere_trace): a cheap march step — one summed-potential eval per
    lane — pauses lanes at isosurface crossings; the expensive
    central-difference normal + validity check runs only on iterations
    where some lane paused. The reference advances t by the constant step
    every iteration including after an invalid crossing
    (hlsli:165-199: `t += minTStep` is unconditional).
    """
    from gpuraytracer.geometry import sdf as _sdf
    from gpuraytracer.geometry.sdf import _chunked

    if chunk_size is None:
        chunk_size = _sdf.DEFAULT_CHUNK_SIZE
    if unroll is None:
        unroll = _sdf.DEFAULT_UNROLL
    if active is None:
        active = (origins[..., 0] + directions[..., 0]) * 0.0 > -1.0
    # Per-ray t_max (the shrinking RayTCurrent analog): scalar broadcasts.
    t_max = jnp.broadcast_to(
        jnp.asarray(t_max, dtype=origins.dtype), origins.shape[:-1]
    )

    centers, radii = animated_metaballs(elapsed_time)

    def trace_batch(origins, directions, active, t_max):
        zero = (origins[..., 0] + directions[..., 0]) * 0.0
        tmin, tmax = find_intersecting_metaballs(
            origins, directions, centers, radii, t_min, t_max
        )
        # Lanes with no bounding-sphere overlap get tmin=+inf/tmax=-inf; the
        # march below produces inf/nan positions there, and every comparison
        # on them is False — same net no-hit as the reference.
        step = (tmax - tmin) / float(max_steps)

        steps0 = zero.astype(jnp.int32)
        # Empty bounding interval (missed every sphere) cannot produce a
        # hit; skip those lanes immediately (result-identical).
        done0 = ~active | ~(tmax >= tmin)
        paused0 = zero > 1.0  # all False
        t_hit0 = zero + jnp.inf

        def cond(state):
            t, steps, done, paused, t_hit = state
            return jnp.any(~done)

        def body(state):
            t, steps, done, paused, t_hit = state

            def check(args):
                t, done, paused, t_hit = args
                pos = origins + t[..., None] * directions
                normal = metaballs_normal(pos, centers, radii)
                facing_ok = jnp.where(
                    cull_backface, hlsl.dot(directions, normal) <= 0.0, True
                )
                in_range = (t >= t_min) & (t <= t_max)
                valid = paused & facing_ok & in_range
                t_hit = jnp.where(valid, t, t_hit)
                done = done | valid
                return t, done, paused, t_hit

            t, done, paused, t_hit = jax.lax.cond(
                jnp.any(paused), check, lambda a: a, (t, done, paused, t_hit)
            )
            # Invalid-crossing survivors take the unconditional step (their
            # crossing eval was counted at pause time), then continue fresh.
            resume = paused & ~done
            paused = paused & ~paused  # all False, correct VMA

            # Unrolled march micro-steps (see sdf.sphere_trace).
            for _ in range(unroll):
                marching = ~done & ~paused
                pos = origins + t[..., None] * directions
                total = metaballs_potential(pos, centers, radii)

                adv_resume = marching & resume
                fresh = marching & ~resume & (steps < max_steps)
                out_of_steps = marching & ~resume & (steps >= max_steps)
                done = done | out_of_steps

                crossed = total >= METABALL_ISO_THRESHOLD
                newly_paused = fresh & crossed
                advance = fresh & ~crossed
                steps = steps + jnp.where(fresh, 1, 0)

                t = jnp.where(adv_resume | advance, t + step, t)
                paused = paused | newly_paused
                resume = resume & ~adv_resume
            return t, steps, done, paused, t_hit

        _, _, _, _, t_hit = jax.lax.while_loop(
            cond, body, (tmin, steps0, done0, paused0, t_hit0)
        )

        hit = jnp.isfinite(t_hit)
        pos_hit = origins + t_hit[..., None] * directions
        safe = jnp.where(hit[..., None], pos_hit, jnp.zeros_like(pos_hit))
        normal = metaballs_normal(safe, centers, radii)
        return hit, jnp.where(hit, t_hit, jnp.inf), normal

    return _chunked(
        trace_batch,
        (origins, directions, active, t_max),
        (0.0, 1.0, False, 0.0),
        chunk_size,
    )
