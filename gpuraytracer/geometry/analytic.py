"""Analytic primitives: hollow unit AABB and the 3-sphere cluster.

Reproduces src/AnalyticPrimitives.hlsli:
  numerically stable quadratic        :28-43
  hollow-sphere test w/ t-range+cull  :64-100
  3 hard-coded spheres, closest wins  :119-153
  slab AABB interval test (inf-safe)  :158-188
  hollow-AABB face-normal variant     :191-219

All tests operate on local-space rays shaped (..., 3) and return
(hit, t, normal) with t = +inf on miss.
"""

from __future__ import annotations

import jax.numpy as jnp

from gpuraytracer.core import hlsl

# The 3 hard-coded spheres (AnalyticPrimitives.hlsli:121-128).
SPHERE_CENTERS = ((-0.3, -0.3, -0.3), (0.1, 0.1, 0.4), (0.35, 0.35, 0.0))
SPHERE_RADII = (0.6, 0.3, 0.15)

AABB_EPS = 0.0001  # face-pick epsilon (hlsli:208)


def solve_ray_sphere(origins, directions, center, radius):
    """Stable quadratic solve; returns (has_roots, t0, t1), t0 <= t1
    (hlsli:28-60)."""
    center = jnp.asarray(center, dtype=origins.dtype)
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
    mid = -0.5 * b / a
    t0 = jnp.where(discr == 0.0, mid, t0)
    t1 = jnp.where(discr == 0.0, mid, t1)
    return has, t0, t1


def _sphere_normal(origins, directions, t, center):
    pos = origins + t[..., None] * directions
    return hlsl.normalize(pos - jnp.asarray(center, dtype=origins.dtype))


def intersect_hollow_sphere(
    origins, directions, center, radius, *, t_min, t_max, cull_backface
):
    """RaySphereIntersectionTest (hlsli:64-100): prefer t0; if t0 < t_min or
    invalid (culled), fall through to t1."""
    has, t0, t1 = solve_ray_sphere(origins, directions, center, radius)

    def valid(t, normal):
        in_range = (t >= t_min) & (t <= t_max)
        facing = jnp.where(cull_backface, hlsl.dot(directions, normal) <= 0.0, True)
        return in_range & facing

    n0 = _sphere_normal(origins, directions, t0, center)
    n1 = _sphere_normal(origins, directions, t1, center)

    t0_before = t0 < t_min
    t1_before = t1 < t_min

    # Branch A (t0 < t_min): only t1 considered, and only if t1 >= t_min.
    hit_a = ~t1_before & valid(t1, n1)
    # Branch B (t0 >= t_min): t0 first, else t1.
    hit_b0 = valid(t0, n0)
    hit_b1 = ~hit_b0 & valid(t1, n1)

    use_a = t0_before
    hit = has & jnp.where(use_a, hit_a, hit_b0 | hit_b1)
    t = jnp.where(use_a | (~use_a & hit_b1 & ~hit_b0), t1, t0)
    normal = jnp.where((use_a | hit_b1)[..., None], n1, n0)
    t = jnp.where(hit, t, jnp.inf)
    return hit, t, normal


def intersect_spheres(origins, directions, *, t_min, t_max, cull_backface):
    """RaySpheresIntersectionTest (hlsli:119-153): three hollow spheres,
    closest valid hit wins (thit initialized to RayTCurrent)."""
    batch = origins.shape[:-1]
    # t_max may be per-ray (the shrinking RayTCurrent analog).
    best_t = jnp.broadcast_to(
        jnp.asarray(t_max, dtype=origins.dtype), batch
    ).astype(origins.dtype)
    best_n = jnp.zeros(origins.shape, dtype=origins.dtype)
    found = jnp.zeros(batch, dtype=bool)
    for center, radius in zip(SPHERE_CENTERS, SPHERE_RADII):
        hit, t, n = intersect_hollow_sphere(
            origins,
            directions,
            center,
            radius,
            t_min=t_min,
            t_max=t_max,
            cull_backface=cull_backface,
        )
        closer = hit & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_n = jnp.where(closer[..., None], n, best_n)
        found = found | closer
    t_out = jnp.where(found, best_t, jnp.inf)
    return found, t_out, best_n


def aabb_interval(origins, directions, aabb_min, aabb_max):
    """Slab-method interval test (hlsli:158-188) with the reference's
    explicit inf handling for axis-parallel rays.

    Returns (tmin, tmax) — callers apply the `tmax > tmin` style predicates.
    """
    aabb_min = jnp.asarray(aabb_min, dtype=origins.dtype)
    aabb_max = jnp.asarray(aabb_max, dtype=origins.dtype)
    d = directions
    inf = jnp.asarray(jnp.inf, dtype=origins.dtype)
    inv = jnp.where(d != 0.0, 1.0 / d, jnp.where(d > 0.0, inf, -inf))
    # sign3 = d > 0: near slab = min bound when heading +, else max bound.
    near = jnp.where(d > 0.0, aabb_min, aabb_max)
    far = jnp.where(d > 0.0, aabb_max, aabb_min)
    tmin3 = (near - origins) * inv
    tmax3 = (far - origins) * inv
    tmin = jnp.max(tmin3, axis=-1)
    tmax = jnp.min(tmax3, axis=-1)
    return tmin, tmax


def aabb_hit_mask(origins, directions, aabb_min, aabb_max, *, t_min, t_max):
    """The boolean form: tmax > tmin && tmax >= t_min && tmin <= t_max
    (hlsli:187). This is also the traversal gate for procedural geometry —
    the DXR-driver AABB test analog."""
    tmin, tmax = aabb_interval(origins, directions, aabb_min, aabb_max)
    return (tmax > tmin) & (tmax >= t_min) & (tmin <= t_max)


def intersect_hollow_aabb(
    origins, directions, *, t_min, t_max, cull_backface, aabb_min=(-1.0, -1.0, -1.0), aabb_max=(1.0, 1.0, 1.0)
):
    """Hollow AABB with face normals (hlsli:191-219). Only entry crossings
    from outside count (tmin within ray extents)."""
    aabb_min_a = jnp.asarray(aabb_min, dtype=origins.dtype)
    aabb_max_a = jnp.asarray(aabb_max, dtype=origins.dtype)
    tmin, tmax = aabb_interval(origins, directions, aabb_min_a, aabb_max_a)
    interval_ok = (tmax > tmin) & (tmax >= t_min) & (tmin <= t_max)
    entry_ok = (tmin >= t_min) & (tmin <= t_max)

    t = tmin
    pos = origins + t[..., None] * directions
    d0 = jnp.abs(aabb_min_a - pos)
    d1 = jnp.abs(aabb_max_a - pos)
    # Priority-ordered face pick (first eps-close face wins), exactly the
    # reference's if/else chain; default normal (0,0,0) if nothing matches.
    zeros = jnp.zeros_like(pos)
    normal = zeros
    picked = jnp.zeros(t.shape, dtype=bool)
    faces = [
        (d0[..., 0], (-1.0, 0.0, 0.0)),
        (d0[..., 1], (0.0, -1.0, 0.0)),
        (d0[..., 2], (0.0, 0.0, -1.0)),
        (d1[..., 0], (1.0, 0.0, 0.0)),
        (d1[..., 1], (0.0, 1.0, 0.0)),
        (d1[..., 2], (0.0, 0.0, 1.0)),
    ]
    for dist, n in faces:
        take = ~picked & (dist < AABB_EPS)
        normal = jnp.where(
            take[..., None], jnp.asarray(n, dtype=origins.dtype), normal
        )
        picked = picked | take

    in_range = (t >= t_min) & (t <= t_max)
    facing = jnp.where(cull_backface, hlsl.dot(directions, normal) <= 0.0, True)
    hit = interval_ok & entry_ok & in_range & facing
    return hit, jnp.where(hit, t, jnp.inf), normal
