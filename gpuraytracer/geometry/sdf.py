"""Signed-distance-field library + sphere-trace intersector.

Reproduces the reference's SDF layer (iq's distfunctions):
  CSG ops / repetition / twist   SignedDistancePrimitives.hlsli:55-114
  primitive distance functions   SignedDistancePrimitives.hlsli:119-273
  tetrahedral-offset normal      SignedDistancePrimitives.hlsli:275-283
  sphere tracing (512 steps,
  relative 1e-4*t threshold)     SignedDistancePrimitives.hlsli:287-319
  the seven composed objects     ProceduralPrimitivesLibrary.hlsli:63-98

All distance functions take positions shaped (..., 3) and return (...,)
distances; they are pure and vmappable. The sphere tracer is a chunked,
early-exiting lax.while_loop over the ray wavefront with a two-phase
pause/check structure — the wavefront form of the per-thread while loop
(SURVEY.md §2.9). It is the portable reference; on a GPU the march runs
in kernels/sdf_march.py instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gpuraytracer.core import hlsl
from gpuraytracer.core.types import (
    FRACTAL_ITERATIONS_COUNT,
    SDF_HIT_THRESHOLD,
    SDF_MAX_STEPS,
    SignedDistancePrimitive,
)

# Wavefront execution tuning (see sphere_trace): rays are processed in
# fixed-size chunks, each with its own early-exiting while loop, taking
# `unroll` march micro-steps per iteration. Module-level so benchmarks and
# deployments can retune without threading parameters everywhere. The
# default is the monolithic batch with 8 unrolled micro-steps; chunking
# stays available for hosts where one pathological lane must not stall
# the full batch.
DEFAULT_CHUNK_SIZE: int | None = None
DEFAULT_UNROLL: int = 8

# ---------------------------------------------------------------------------
# CSG operators (hlsli:55-114)
# ---------------------------------------------------------------------------

def op_subtract(d1, d2):
    """opS: Obj1 - Obj2 = max(d1, -d2)."""
    return jnp.maximum(d1, -d2)


def op_union(d1, d2):
    return jnp.minimum(d1, d2)


def op_intersect(d1, d2):
    return jnp.maximum(d1, d2)


def op_rep(p, c):
    """Domain repetition: fmod(p, c) - 0.5*c. HLSL fmod semantics (sign
    follows dividend) are load-bearing here — jnp.mod would shift geometry."""
    c = jnp.asarray(c, dtype=p.dtype)
    return hlsl.fmod(p, c) - 0.5 * c


def op_twist(p):
    """Rotate xz by angle 3*y (hlsli:108-114)."""
    c = jnp.cos(3.0 * p[..., 1])
    s = jnp.sin(3.0 * p[..., 1])
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    # HLSL: mul(float2x2(c, -s, s, c), p.xz) = (c*x - s*z, s*x + c*z)
    return hlsl.vec3(c * x - s * z, s * x + c * z, y)


def smin(a, b, k):
    h = jnp.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return hlsl.lerp(b, a, h) - k * h * (1.0 - h)


def smax(a, b, k):
    h = jnp.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return hlsl.lerp(a, b, h) + k * h * (1.0 - h)


# ---------------------------------------------------------------------------
# Primitive distance functions (hlsli:119-273)
# ---------------------------------------------------------------------------

def sd_plane(p):
    return p[..., 1]


def sd_sphere(p, s):
    return hlsl.length(p) - s


def sd_box(p, b):
    b = jnp.asarray(b, dtype=p.dtype)
    d = jnp.abs(p) - b
    return jnp.minimum(jnp.max(d, axis=-1), 0.0) + hlsl.length(jnp.maximum(d, 0.0))


def ud_round_box(p, b, r):
    b = jnp.asarray(b, dtype=p.dtype)
    return hlsl.length(jnp.maximum(jnp.abs(p) - b, 0.0)) - r


def _length_xz(p):
    # hypot over the x/z components without fancy-index gathers.
    return jnp.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])


def sd_torus(p, t):
    """t = (radius, tube radius)."""
    q_x = _length_xz(p) - t[0]
    q = jnp.stack([q_x, p[..., 1]], axis=-1)
    return hlsl.length(q) - t[1]


def sd_cylinder(p, h):
    """h = (radius, half height)."""
    d_x = jnp.abs(_length_xz(p)) - h[0]
    d_y = jnp.abs(p[..., 1]) - h[1]
    d = jnp.stack([d_x, d_y], axis=-1)
    return jnp.minimum(jnp.maximum(d_x, d_y), 0.0) + hlsl.length(jnp.maximum(d, 0.0))


def length_to_pow_negative8(p2):
    """(x^8 + y^8)^(1/8) over a trailing-axis-2 vector (hlsli:252-256)."""
    q = p2 * p2
    q = q * q
    q = q * q
    return jnp.power(q[..., 0] + q[..., 1], 1.0 / 8.0)


def sd_torus82(p, t):
    """Square-profile torus: L2 ring distance, L8 tube norm (hlsli:258-262)."""
    q_x = _length_xz(p) - t[0]
    q = jnp.stack([q_x, p[..., 1]], axis=-1)
    return length_to_pow_negative8(q) - t[1]


def sd_octahedron(p, h):
    """h = (sin a, cos a, height) (hlsli:220-231)."""
    d = (
        jnp.maximum(jnp.abs(p[..., 0]), jnp.abs(p[..., 2])) * h[0]
        + jnp.abs(p[..., 1]) * h[1]
    )
    return d - h[1] * h[2]


def sd_pyramid(p, h):
    """Pyramid sitting on the ground plane: octahedron minus bottom half
    (hlsli:236-242)."""
    return op_subtract(sd_octahedron(p, h), p[..., 1])


def sd_fractal_pyramid(p, h, scale=2.0, iterations=FRACTAL_ITERATIONS_COUNT):
    """Sierpinski-style recursive pyramid (SignedDistanceFractals.hlsli:34-63).

    `iterations` folds of closest-of-5-vertices space folding
    p <- scale*p - v*(scale-1), then sdPyramid rescaled by scale^-n.
    """
    a = h[2] * h[1] / h[0]
    vertices = [
        jnp.asarray([0.0, h[2], 0.0], dtype=p.dtype),
        jnp.asarray([-a, 0.0, a], dtype=p.dtype),
        jnp.asarray([a, 0.0, -a], dtype=p.dtype),
        jnp.asarray([a, 0.0, a], dtype=p.dtype),
        jnp.asarray([-a, 0.0, -a], dtype=p.dtype),
    ]

    for _ in range(iterations):
        # Closest vertex by squared distance via a branchless select chain
        # (strict <, ties keep the earlier vertex, like the reference's
        # if-chain); selects stay fully vectorized, with no gather.
        best_v = jnp.broadcast_to(vertices[0], p.shape)
        best_d = hlsl.length_sq(p - vertices[0])
        for v in vertices[1:]:
            dv = hlsl.length_sq(p - v)
            closer = dv < best_d
            best_v = jnp.where(closer[..., None], v, best_v)
            best_d = jnp.where(closer, dv, best_d)
        p = scale * p - best_v * (scale - 1.0)

    return sd_pyramid(p, h) * (scale ** (-float(iterations)))


# ---------------------------------------------------------------------------
# The seven composed scene objects (ProceduralPrimitivesLibrary.hlsli:63-98)
# ---------------------------------------------------------------------------

def distance_mini_spheres(p):
    """Repeated sphere lattice intersected with the unit box."""
    return op_intersect(
        sd_sphere(op_rep(p + 1.0, (2.0 / 4.0, 2.0 / 4.0, 2.0 / 4.0)), 0.65 / 4.0),
        sd_box(p, (1.0, 1.0, 1.0)),
    )


def distance_intersected_round_cube(p):
    return op_subtract(
        op_subtract(ud_round_box(p, (0.75, 0.75, 0.75), 0.2), sd_sphere(p, 1.20)),
        -sd_sphere(p, 1.32),
    )


def distance_square_torus(p):
    return sd_torus82(p, (0.75, 0.15))


def distance_twisted_torus(p):
    return sd_torus(op_twist(p), (0.6, 0.2))


def distance_cog(p):
    """Torus82 ring minus angularly repeated cylinders (teeth); the repetition
    runs in polar coordinates (atan2-based) — hlsli:79-85."""
    polar = hlsl.vec3(
        jnp.arctan2(p[..., 2], p[..., 0]) / 6.2831,
        jnp.ones_like(p[..., 0]),
        0.015 + 0.25 * hlsl.length(p),
    )
    teeth = sd_cylinder(op_rep(polar + 1.0, (0.05, 1.0, 0.075)), (0.02, 0.8))
    return op_subtract(sd_torus82(p, (0.60, 0.3)), teeth)


def distance_cylinder(p):
    return op_intersect(
        sd_cylinder(op_rep(p + 1.0, (1.0, 2.0, 1.0)), (0.3, 2.0)),
        sd_box(p + 1.0, (2.0, 2.0, 2.0)),
    )


def distance_fractal_pyramid(p):
    """Base at y == -1 of the unit AABB; 63.435deg base angle, height 2."""
    return sd_fractal_pyramid(
        p + jnp.asarray([0.0, 1.0, 0.0], dtype=p.dtype), (0.894, 0.447, 2.0), 2.0
    )


# Static dispatch table: primitive type code (int) -> distance function.
# (The lax.switch-free analog of GetDistanceFromSignedDistancePrimitive —
# geometry type codes are known at trace time for a built scene.) Extended
# primitives (geometry/fractal.py: Mandelbulb, quaternion Julia) register
# additional codes past the reference's 0..6.
DISTANCE_FUNCTIONS = {
    int(SignedDistancePrimitive.MINI_SPHERES): distance_mini_spheres,
    int(SignedDistancePrimitive.INTERSECTED_ROUND_CUBE): distance_intersected_round_cube,
    int(SignedDistancePrimitive.SQUARE_TORUS): distance_square_torus,
    int(SignedDistancePrimitive.TWISTED_TORUS): distance_twisted_torus,
    int(SignedDistancePrimitive.COG): distance_cog,
    int(SignedDistancePrimitive.CYLINDER): distance_cylinder,
    int(SignedDistancePrimitive.FRACTAL_PYRAMID): distance_fractal_pyramid,
}

# Codes verified (analysis above + tests/test_sdf.py empirical pin) to lie
# inside the march_escape_t envelope: Lipschitz-lower-bound slope >= 0.4
# and support radius <= 2.5 local units. Every marcher that applies the
# escape bound is restricted to this set; codes registered WITHOUT an
# envelope proof must be AABB-windowed instead (register_distance_function).
ESCAPE_SAFE_CODES = frozenset(DISTANCE_FUNCTIONS)


def register_distance_function(code, fn, *, escape_envelope_verified=False,
                               aabb_windowed=False):
    """Register an extension distance function (codes past the reference's
    0..6). Loud contract for the escape bound (march_escape_t): either the
    caller asserts the slope-0.4 / radius-2.5 envelope holds
    (escape_envelope_verified=True, adding the code to ESCAPE_SAFE_CODES)
    or the primitive must use AABB-windowed march semantics
    (aabb_windowed=True — marches stop at the slab exit, never relying on
    the envelope). Anything else would silently retire marches early and
    lose hits for SDFs outside the envelope."""
    global ESCAPE_SAFE_CODES
    code = int(code)
    if not (escape_envelope_verified or aabb_windowed):
        raise ValueError(
            f"distance function code {code}: declare either "
            "escape_envelope_verified=True (slope >= 0.4, support radius "
            "<= 2.5 in local units) or aabb_windowed=True"
        )
    DISTANCE_FUNCTIONS[code] = fn
    if escape_envelope_verified:
        ESCAPE_SAFE_CODES = ESCAPE_SAFE_CODES | {code}


def get_distance(p, primitive):
    return DISTANCE_FUNCTIONS[int(primitive)](p)


# ---------------------------------------------------------------------------
# Normal + sphere tracer (hlsli:275-319)
# ---------------------------------------------------------------------------

def calculate_normal(pos, distance_fn):
    """Tetrahedral-offset gradient estimate, e = 0.5773e-4."""
    e = 0.5773 * 0.0001
    exyy = jnp.asarray([e, -e, -e], dtype=pos.dtype)
    eyyx = jnp.asarray([-e, -e, e], dtype=pos.dtype)
    eyxy = jnp.asarray([-e, e, -e], dtype=pos.dtype)
    exxx = jnp.asarray([e, e, e], dtype=pos.dtype)
    n = (
        exyy * distance_fn(pos + exyy)[..., None]
        + eyyx * distance_fn(pos + eyyx)[..., None]
        + eyxy * distance_fn(pos + eyxy)[..., None]
        + exxx * distance_fn(pos + exxx)[..., None]
    )
    return hlsl.normalize(n)


def _chunked(batch_fn, per_lane_args, fills, chunk_size):
    """Run a per-lane-independent wavefront loop in fixed-size chunks via
    lax.map, so each chunk's while_loop terminates on ITS slowest lane
    rather than the global batch's. Chunks whose gate mask is empty exit
    after zero iterations — with 10 geometries each covering a small screen
    region, most chunks skip most geometries. This is the XLA-level form of
    the per-block march of kernels/sdf_march.py.

    batch_fn(*per_lane_args) -> pytree of (chunk, ...) results. The first
    arg must be the (.., 3) origins array (defines the batch shape); `fills`
    supplies padding values per arg.
    """
    origins = per_lane_args[0]
    batch_shape = origins.shape[:-1]
    n = 1
    for s in batch_shape:
        n *= s
    if chunk_size is None or n <= chunk_size:
        return batch_fn(*per_lane_args)

    pad = (-n) % chunk_size
    c = (n + pad) // chunk_size

    def flat(x, fill):
        x = x.reshape((n,) + x.shape[len(batch_shape):])
        if pad:
            pad_widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            x = jnp.pad(x, pad_widths, constant_values=fill)
        return x.reshape((c, chunk_size) + x.shape[1:])

    chunked_args = tuple(flat(x, f) for x, f in zip(per_lane_args, fills))
    outs = jax.lax.map(lambda args: batch_fn(*args), chunked_args)

    def unflat(x):
        x = x.reshape((c * chunk_size,) + x.shape[2:])
        return x[:n].reshape(batch_shape + x.shape[1:])

    return jax.tree_util.tree_map(unflat, outs)


# --- march escape bound (result-identical early retirement) ---------------
#
# Every REFERENCE distance function is lower-bounded by a cone in |p|:
#   dist(p) >= |p| / ESCAPE_ALPHA_INV - ESCAPE_RADIUS / ESCAPE_ALPHA_INV
# Per-primitive analysis (tests/test_sdf.py pins it empirically out to
# |p| = 300): box/sphere-bounded composites (mini spheres, round cube,
# cylinder) have Euclidean slope 1 and radius <= 2; the torus82 family
# (square/twisted torus, cog — subtraction only raises the distance)
# slope >= 0.5; the fractal pyramid's 2^4 fold cancels against its
# 2^-4 rescale, leaving sd_octahedron's minimum Euclidean slope 0.447
# and radius ~0.9. Global safe envelope: slope 0.4, radius 2.5, doubled
# margin below. Extension DE fractals (codes >= 7) never rely on this
# bound — their marches are AABB-windowed (accel/traverse.py).
# A march crossing needs dist <= SDF_HIT_THRESHOLD * t at p = o + t*d, and
# |p| >= t*|d| - |o|, so no crossing can exist once
#   t * (|d| - ESCAPE_ALPHA_INV * threshold) > |o| + ESCAPE_RADIUS.
# Retiring marching lanes past that t is therefore bit-identical to the
# reference's march to t > RayTCurrent (it would never cross again), while
# sky/occlusion lanes whose RayTCurrent is 10000 stop ~2 orders of
# magnitude sooner. (DEVNOTES "skipping work whose result cannot win".)

ESCAPE_ALPHA_INV = 2.5
ESCAPE_RADIUS = 12.0  # already multiplied by ESCAPE_ALPHA_INV (2x margin)


def march_escape_t(o_norm, d_norm):
    """Upper bound on any possible crossing t for a local-space ray with
    |origin| = o_norm, |direction| = d_norm (see derivation above)."""
    denom = jnp.maximum(d_norm - ESCAPE_ALPHA_INV * SDF_HIT_THRESHOLD, 1e-6)
    return (o_norm + ESCAPE_RADIUS) / denom


# --- over-relaxed sphere tracing (extension primitives only) --------------
#
# Keinert et al. 2014 ("Enhanced Sphere Tracing"): cruise steps use
# omega * step_scale * dist; an overshoot is detected when consecutive
# safety spheres are disjoint — dist_i + dist_{i-1} < omega * dist_{i-1},
# the step_scale cancels — in which case the lane steps BACK to a point
# inside the previous safety sphere ((1-omega) of the relaxed step) and
# marches plainly from there on. No crossing can be missed: a surface
# between two samples forces the disjoint condition (the DE underestimates
# distance), so every overshoot is caught and replayed at omega = 1.
#
# Applied ONLY to extension DE fractals (codes >= 7, the AABB-windowed
# set): the reference primitives keep the reference's exact step sequence
# for parity (BASELINE 1e-3 budget), and their escape-cone retirement
# argument assumes unrelaxed steps. Relaxed lanes retire on the
# UNRELAXED reach (t + step_scale*dist > window exit) — the same
# no-crossing-within-reach argument as the plain marcher, sound under
# overshoot. Sweepable via GPURT_RELAX; 1.0 disables.
RELAX_OMEGA = 1.6


def extension_relax() -> float:
    import os

    try:
        v = float(os.environ.get("GPURT_RELAX", RELAX_OMEGA))
    except ValueError:
        return RELAX_OMEGA
    return v if v > 1.0 else 1.0


def reference_relax() -> float:
    """Opt-in over-relaxation for the REFERENCE primitives (codes 0-6).

    Default 1.0 (off): the default path keeps the reference's exact step
    sequence (SignedDistancePrimitives.hlsli:287-319) so march crossings
    stay bit-aligned with the CPU reference. Setting GPURT_RELAX_REF
    (e.g. 1.6) enables Keinert over-relaxation for them too — the same
    back-step-on-disjoint-spheres scheme as extension_relax, sound for
    the same reason, but hit t's shift within the crossing-threshold
    scale, so silhouette pixels can move. Profiling / opt-in only."""
    import os

    try:
        v = float(os.environ.get("GPURT_RELAX_REF", "1.0"))
    except ValueError:
        return 1.0
    return v if v > 1.0 else 1.0


def occlusion_relax() -> float:
    """Over-relaxation for OCCLUSION (accept-first shadow) marches.

    A shadow query's result is one boolean (Raytracing.hlsl:115-147 —
    SKIP_CLOSEST_HIT: no t, no normal, no shading ever reads the march's
    landing point), so the hit-t shifts that keep over-relaxation opt-in
    for radiance marches (reference_relax) are invisible here: the
    back-step-on-disjoint-spheres fallback preserves WHICH surface gets
    hit, and hit/no-hit can only flip for rays grazing within rounding of
    the crossing threshold. Measured on the builtin scene (CPU A/B at
    320x180): 99.998% of pixels within 1e-3 at omega 1.6 AND 2.0 (max abs
    0.0028). Default 1.6, chosen for speed on the previous accelerator;
    its speed on the GPU is not measured yet. GPURT_RELAX_SHADOW=1.0
    restores the exact reference step sequence. Radiance marches stay
    exact by default: the same A/B on GPURT_RELAX_REF moved 5.2% of
    pixels (max 2.0) because back-step hit-t shifts perturb normals on
    reflective surfaces."""
    import os

    try:
        v = float(os.environ.get("GPURT_RELAX_SHADOW", "1.6"))
    except ValueError:
        return 1.6
    return v if v > 1.0 else 1.0


def relax_for_code(code: int, occlusion: bool = False) -> float:
    base = extension_relax() if int(code) >= 7 else reference_relax()
    return max(base, occlusion_relax()) if occlusion else base


def shadow_budget_cap() -> int:
    """Step-budget cap for OCCLUSION marches (GPURT_SHADOW_BUDGET).

    A shadow march that exhausts its budget without a crossing reports
    "OCCLUDED" — conservative: a capped march has not proven light
    visibility, and capped lanes crawl along near-occluders the
    reference's full 512-step march almost always confirms
    (closest=>occluded invariant, tests/test_properties.py; with the
    caps off the full-budget march keeps the reference's exact
    miss-on-exhaustion semantics). Under that round-5 semantics the
    accuracy curve improved ~4x vs the old capped=>lit form — measured
    sweep on the builtin scene (CPU accuracy at 320x180, vs the uncapped
    reference semantics): cap 128 -> 0.031% of pixels move > 1e-3; 96 ->
    0.064%; 64 -> 0.247%; 48 -> 1.34%. Default 96 — combined with every
    other default the distance from the exact-semantics anchor is 0.46%
    (DEVNOTES round-5), inside the 0.5% acceptance standard; 64 pushes the
    combined distance to 0.65-0.79% and was rejected. 0 disables
    (occlusion marches inherit the geometry's full budget). Read at trace
    time like the relax knobs; applied identically in the GPU kernel and
    the XLA march."""
    import os

    try:
        v = int(float(os.environ.get("GPURT_SHADOW_BUDGET", "96")))
    except ValueError:
        return 96
    # <= 1 disables (1 is a meaningless march; it also lets the accuracy
    # A/B tool's omega=1.0 baseline mean "off" for this knob too).
    return v if v > 1 else 0


def cap_occlusion_budget(budget: int, bounce: bool = False) -> int:
    cap = shadow_budget_cap()
    budget = min(int(budget), cap) if cap else int(budget)
    if bounce:
        bcap = bounce_shadow_budget_cap()
        if bcap:
            budget = min(budget, bcap)
    return budget


def bounce_shadow_budget_cap() -> int:
    """Extra step-budget cap for BOUNCE-level occlusion marches
    (GPURT_SHADOW_BUDGET_B; shadow@1 — shadows of reflected hits,
    Raytracing.hlsl:117-120 traces shadows at recursion depths 0 and 1
    only). A shadow@1 error flips the 0.35 shadow factor on a color term
    already scaled by the parent reflection's throughput (reflectance *
    Fresnel <= ~0.55 chromium / ~0.25 plane), so it tolerates a cap the
    primary shadow can't. Accuracy measured per the standard CPU A/B
    (builtin, 320x180) before defaulting — see DEVNOTES round 3. 0
    disables (shadow@1 inherits GPURT_SHADOW_BUDGET). Both marchers honor
    it through the traced per-level budget (accel/traverse.py)."""
    import os

    try:
        v = int(float(os.environ.get("GPURT_SHADOW_BUDGET_B", "64")))
    except ValueError:
        return 64
    return v if v > 1 else 0


def radiance_budget_cap() -> int:
    """Step-budget cap for RADIANCE (closest-hit) marches
    (GPURT_MARCH_BUDGET). Unlike the occlusion cap, a capped-out radiance
    march mis-shades the pixel outright (background/plane showthrough at
    silhouettes) — but the measured tail is tiny: on the builtin scene
    (CPU accuracy at 320x180, vs the uncapped reference semantics) cap 256 moves 0.003% of pixels > 1e-3,
    192 -> 0.002%, 160 -> 0.023%, 128 -> 0.113%. Rays still marching
    past ~160 steps are crawling along grazing silhouettes; almost all
    end as misses anyway. Default 160 (round-5: combined-with-all-
    defaults distance from the exact anchor 0.46%, inside the 0.5%
    standard); 0 disables (full reference 512-step budget). Per-scene
    budgets below the cap are unaffected."""
    import os

    try:
        v = int(float(os.environ.get("GPURT_MARCH_BUDGET", "160")))
    except ValueError:
        return 160
    return v if v > 1 else 0


def cap_radiance_budget(budget: int, bounce: bool = False) -> int:
    cap = radiance_budget_cap()
    budget = min(int(budget), cap) if cap else int(budget)
    if bounce:
        bcap = bounce_radiance_budget_cap()
        if bcap:
            budget = min(budget, bcap)
    return budget


def bounce_radiance_budget_cap() -> int:
    """Extra step-budget cap for BOUNCE-level radiance marches
    (GPURT_MARCH_BUDGET_B; closest-hit at recursion depths >= 1). A
    capped-out bounce march mis-shades a REFLECTION, so the error lands
    scaled by the parent hit's throughput (reflectance * Fresnel <= ~0.55
    chromium / ~0.25 plane; <= the product at depth 2) instead of
    full-strength like a primary miss. Accuracy measured per the standard
    CPU A/B (builtin, 320x180) before defaulting — see DEVNOTES round 3.
    0 disables (bounce levels inherit GPURT_MARCH_BUDGET)."""
    import os

    try:
        v = int(float(os.environ.get("GPURT_MARCH_BUDGET_B", "128")))
    except ValueError:
        return 128
    return v if v > 1 else 0


def sphere_trace(
    origins,
    directions,
    distance_fn,
    *,
    step_scale=1.0,
    t_min=0.0,
    t_max,
    cull_backface,
    active=None,
    max_steps: int = SDF_MAX_STEPS,
    chunk_size: int | None = None,
    unroll: int | None = None,
    escape_bound: bool = True,
    relax: float = 1.0,
    capped_hit=False,
):
    """Wavefront sphere tracer reproducing RaySignedDistancePrimitiveTest.

    March from t = t_min (the reference marches from RayTMin() == 0, NOT the
    AABB entry point) in steps of step_scale * distance until
    distance <= 1e-4 * t; a crossing only terminates the march if the hit is
    valid (in [t_min, t_max] and not back-face culled) — invalid crossings
    keep marching, exactly like the reference's loop (hlsli:295-317).

    capped_hit (bool or traced scalar bool): when truthy, lanes that
    exhaust a REDUCED step budget without resolving report a hit at
    their current t — the conservative occlusion semantics that keeps
    closest=>occluded intact under budget caps (a capped occlusion
    march has not proven light visibility; the only consumer is the
    0.35 shadow factor). Callers pass it only for occlusion queries
    whose effective budget sits BELOW the geometry's natural one, so
    knob-off runs keep the reference's exact miss-on-exhaustion
    semantics (SignedDistancePrimitives.hlsli:291-317).

    Execution shape: the per-thread while loop becomes an
    early-exiting lax.while_loop over the whole wavefront with a two-phase
    body — a cheap march step (ONE distance eval per lane) that PAUSES lanes
    at isosurface crossings, and a validity check (the 4-eval tetrahedral
    normal + cull test) that only runs on iterations where some lane is
    paused. Invalid crossings resume the march with the reference's own
    tiny/negative step. Semantics are identical to evaluating the validity
    at every crossing in-line; cost is ~5x lower, and geometries whose AABB
    gate masked out every lane exit after zero iterations.

    origins/directions: (..., 3) in the primitive's local space; t is the
    world-space ray parameter (instance transforms here are scale-free in
    BLAS->world so the parameter is shared — see accel/instances.py).

    Returns (hit_mask, t_hit, normal).
    """
    if chunk_size is None:
        chunk_size = DEFAULT_CHUNK_SIZE
    if unroll is None:
        unroll = DEFAULT_UNROLL
    if active is None:
        # Varying like the rays (see _chunked docstring / shard_map VMA).
        active = (origins[..., 0] + directions[..., 0]) * 0.0 > -1.0
    # Per-ray t_max (the shrinking RayTCurrent analog): scalar broadcasts.
    t_max = jnp.broadcast_to(
        jnp.asarray(t_max, dtype=origins.dtype), origins.shape[:-1]
    )

    def trace_batch(origins, directions, active, t_max):
        zero = (origins[..., 0] + directions[..., 0]) * 0.0
        # Result-identical march retirement bound (see march_escape_t).
        # Callers marching a distance function OUTSIDE the verified
        # envelope (ESCAPE_SAFE_CODES) must pass escape_bound=False.
        if escape_bound:
            t_escape = jnp.minimum(
                t_max,
                march_escape_t(
                    jnp.linalg.norm(origins, axis=-1),
                    jnp.linalg.norm(directions, axis=-1),
                ),
            )
        else:
            t_escape = t_max
        t0 = zero + t_min
        steps0 = zero.astype(jnp.int32)
        done0 = ~active
        paused0 = zero > 1.0  # all False
        t_hit0 = zero + jnp.inf
        relaxed = relax > 1.0
        if relaxed:
            # Over-relaxation carries (see extension_relax): previous
            # radius, and the per-lane "omega still on" flag (disabled
            # forever on the first overshoot or resume — Keinert 2014).
            state0 = (t0, steps0, done0, paused0, t_hit0, zero,
                      steps0 + 1)
        else:
            state0 = (t0, steps0, done0, paused0, t_hit0)

        def cond(state):
            return jnp.any(~state[2])

        def body(state):
            if relaxed:
                t, steps, done, paused, t_hit, rprev, oon_i = state
                oon = oon_i != 0
            else:
                t, steps, done, paused, t_hit = state

            # -- validity phase: lanes paused at a crossing get the full
            # check (the body of the reference's
            # `if (distance <= threshold * t)`). Valid -> done with t_hit;
            # invalid -> stays paused, resumes below.
            def check(args):
                t, done, paused, t_hit = args
                pos = origins + t[..., None] * directions
                normal = calculate_normal(pos, distance_fn)
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
            # Invalid-crossing survivors take the step the reference takes
            # AFTER its failed validity check — t += scale*dist at the
            # crossing point, uncounted (their crossing eval was counted at
            # pause time) — then continue as fresh lanes.
            resume = paused & ~done
            paused = paused & ~paused  # all False, correct VMA

            # `unroll` march micro-steps per while iteration: cuts the
            # sequential iteration count (and its fixed scalar-core cost)
            # ~unroll-fold. Lanes that cross mid-segment freeze until the
            # next check phase; per-lane eval/step accounting is identical
            # to the single-step form.
            for _ in range(unroll):
                marching = ~done & ~paused
                pos = origins + t[..., None] * directions
                dist = distance_fn(pos)

                adv_resume = marching & resume
                fresh = marching & ~resume & (steps < max_steps)
                out_of_steps = marching & ~resume & (steps >= max_steps)
                done = done | out_of_steps

                if relaxed:
                    # Overshoot: consecutive safety spheres disjoint
                    # (step_scale cancels from both sides).
                    fail = fresh & oon & (dist + rprev < relax * rprev)
                    crossed = (dist <= SDF_HIT_THRESHOLD * t) & ~fail
                else:
                    crossed = dist <= SDF_HIT_THRESHOLD * t
                newly_paused = fresh & crossed
                advance = fresh & ~crossed
                steps = steps + jnp.where(fresh, 1, 0)

                moved = adv_resume | advance
                if relaxed:
                    # Retire on the UNRELAXED reach: no crossing can lie
                    # within step_scale*dist of the sample — sound ONLY
                    # for lanes whose sphere chain is intact. A lane in a
                    # failed-overshoot state (disjoint spheres) may have
                    # skipped a crossing BEHIND the sample; it must
                    # back-step, not retire (the old unconditional retire
                    # dropped real occluders at scene-exit grazes —
                    # tests/test_properties.py closest=>occluded).
                    done = done | (
                        moved & ~fail & (t + step_scale * dist > t_escape)
                    )
                    plain = step_scale * dist
                    fail_step = ((1.0 - relax) * relax) * (step_scale * rprev)
                    stepv = jnp.where(
                        fail, fail_step,
                        jnp.where(oon & ~adv_resume, relax * plain, plain),
                    )
                    t = jnp.where(moved, t + stepv, t)
                    oon = oon & ~fail & ~adv_resume
                    rprev = jnp.where(moved, dist, rprev)
                else:
                    t = jnp.where(moved, t + step_scale * dist, t)
                    # Reference re-checks `t <= RayTCurrent()` before the
                    # next eval; past t_escape no crossing can ever occur,
                    # so retiring there too is result-identical.
                    done = done | (moved & (t > t_escape))
                paused = paused | newly_paused
                resume = resume & ~adv_resume
            if relaxed:
                return (t, steps, done, paused, t_hit, rprev,
                        oon.astype(jnp.int32))
            return t, steps, done, paused, t_hit

        final = jax.lax.while_loop(cond, body, state0)
        t_hit = final[4]

        if capped_hit is not False:
            # Conservative occlusion on budget exhaustion (see docstring):
            # same capped-lane definition as kernels/sdf_march.py so both
            # paths agree.
            capped = active & (final[1] >= max_steps) & ~jnp.isfinite(t_hit)
            capped = capped & capped_hit
            t_hit = jnp.where(capped, final[0], t_hit)

        hit = jnp.isfinite(t_hit)
        pos_hit = origins + t_hit[..., None] * directions
        # Recompute the normal at the accepted position (masked to avoid
        # nan/inf positions on miss lanes).
        safe_pos = jnp.where(hit[..., None], pos_hit, jnp.zeros_like(pos_hit))
        normal = calculate_normal(safe_pos, distance_fn)
        return hit, jnp.where(hit, t_hit, jnp.inf), normal

    return _chunked(
        trace_batch,
        (origins, directions, active, t_max),
        (0.0, 1.0, False, 0.0),
        chunk_size,
    )
