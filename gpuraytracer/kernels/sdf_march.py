"""Sphere-trace march as a Pallas kernel for NVIDIA GPUs (Triton route).

The XLA form (geometry/sdf.sphere_trace) marches every ray of the batch in
one whole-batch while loop: each iteration reads and writes the full march
state in device memory, and the loop runs until the slowest lane of the
whole batch is done. This kernel marches one ray per lane instead:

  - rays are flattened to 1-D lanes in structure-of-arrays planes and cut
    into power-of-two blocks; every block runs its own while loop and exits
    when its own lanes are done;
  - the march state (t, steps, done, paused, t_hit) lives in loop carries,
    i.e. registers, never in device memory;
  - a block whose gate mask is empty loads no ray and marches nothing (the
    per-block analog of DXR skipping geometry whose AABB the ray misses);
  - the 4-eval tetrahedral validity check runs only on iterations where
    some lane of the block paused at a crossing, and the hit normal is
    computed in the epilogue only for blocks with a hit.

Semantics are exactly those of geometry/sdf.sphere_trace (two-phase
pause/check march, escape bound, over-relaxation, conservative capped
occlusion hits, per-lane march start, traced step budget); the tests pin
the two against each other. Block reductions are written as int32 max,
since the Triton lowering has no boolean reduction.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpuraytracer.core.types import SDF_HIT_THRESHOLD
from gpuraytracer.kernels.soa import DISTANCE_FUNCTIONS_SOA, V3

# Block shape, warps per block and micro-steps between two block-wide
# reductions, chosen by the sweep on the card recorded in DEVNOTES.md: a
# block of a 2-D batch is one compact 8 x 16 screen tile, whose rays end
# their marches at similar steps, so fewer lanes idle until the block's
# slowest is done.
TILE = (8, 16)
BLOCK = TILE[0] * TILE[1]
NUM_WARPS = 4
UNROLL = 4

_NORMAL_EPS = 0.5773 * 0.0001


def kernel_available(prim_code: int) -> bool:
    """The Triton march runs where JAX's default backend is a GPU, for the
    distance functions that have an SoA form."""
    return (jax.default_backend() == "gpu"
            and int(prim_code) in DISTANCE_FUNCTIONS_SOA)


def _any(mask) -> jnp.ndarray:
    return jnp.max(mask.astype(jnp.int32)) > 0


def _normal_at(distance_fn, p: V3) -> V3:
    """sdf.calculate_normal in SoA form (tetrahedral offsets)."""
    e = _NORMAL_EPS
    d1 = distance_fn(V3(p.x + e, p.y - e, p.z - e))
    d2 = distance_fn(V3(p.x - e, p.y - e, p.z + e))
    d3 = distance_fn(V3(p.x - e, p.y + e, p.z - e))
    d4 = distance_fn(V3(p.x + e, p.y + e, p.z + e))
    return V3(
        e * d1 - e * d2 - e * d3 + e * d4,
        -e * d1 - e * d2 + e * d3 + e * d4,
        -e * d1 + e * d2 - e * d3 + e * d4,
    ).normalized()


def _march_block(distance_fn, o: V3, d: V3, gate, t_lo, t_hi, step_scale,
                 max_steps, capped_hit, *, cull_backface, escape_bound,
                 relax, unroll):
    """One block's march. Returns (t_hit, normal); t_hit is inf on miss."""
    from gpuraytracer.geometry.sdf import march_escape_t

    relaxed = relax > 1.0
    inf = jnp.float32(jnp.inf)
    if escape_bound:
        t_escape = jnp.minimum(t_hi, march_escape_t(o.length(), d.length()))
    else:
        t_escape = t_hi
    izero = jnp.zeros_like(gate, dtype=jnp.int32)
    state0 = (t_lo, izero, jnp.where(gate, izero, izero + 1), izero,
              t_lo * 0.0 + inf)
    if relaxed:
        state0 += (t_lo * 0.0, izero + 1)

    def check(t, done, paused, t_hit):
        # The body of the reference's `if (distance <= threshold * t)`:
        # valid crossings finish the lane, invalid ones resume marching.
        if cull_backface:
            pos = V3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
            facing_ok = d.dot(_normal_at(distance_fn, pos)) <= 0.0
        else:
            facing_ok = t == t
        valid = (paused != 0) & facing_ok & (t >= t_lo) & (t <= t_hi)
        return jnp.where(valid, 1, done), jnp.where(valid, t, t_hit)

    def cond(state):
        return jnp.max(1 - state[2]) > 0

    def body(state):
        if relaxed:
            t, steps, done_i, paused_i, t_hit, rprev, oon_i = state
            oon = oon_i != 0
        else:
            t, steps, done_i, paused_i, t_hit = state
        done_i, t_hit = jax.lax.cond(
            jnp.max(paused_i) > 0,
            lambda: check(t, done_i, paused_i, t_hit),
            lambda: (done_i, t_hit),
        )
        done = done_i != 0
        resume = (paused_i != 0) & ~done
        paused = done & ~done  # all False
        for _ in range(unroll):
            marching = ~done & ~paused
            dist = distance_fn(V3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z))
            adv_resume = marching & resume
            fresh = marching & ~resume & (steps < max_steps)
            done = done | (marching & ~resume & (steps >= max_steps))
            if relaxed:
                fail = fresh & oon & (dist + rprev < relax * rprev)
                crossed = (dist <= SDF_HIT_THRESHOLD * t) & ~fail
            else:
                crossed = dist <= SDF_HIT_THRESHOLD * t
            newly_paused = fresh & crossed
            advance = fresh & ~crossed
            steps = steps + jnp.where(fresh, 1, 0)
            moved = adv_resume | advance
            if relaxed:
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
                done = done | (moved & (t > t_escape))
            paused = paused | newly_paused
            resume = resume & ~adv_resume
        out = (t, steps, done.astype(jnp.int32), paused.astype(jnp.int32),
               t_hit)
        if relaxed:
            out += (rprev, oon.astype(jnp.int32))
        return out

    final = jax.lax.while_loop(cond, body, state0)
    t, steps, t_hit = final[0], final[1], final[4]
    # Conservative occlusion on budget exhaustion (see sdf.sphere_trace).
    capped = gate & (steps >= max_steps) & (t_hit == inf) & (capped_hit != 0)
    t_hit = jnp.where(capped, t, t_hit)
    hit = t_hit < inf

    def normal():
        p = V3(jnp.where(hit, o.x + t_hit * d.x, 0.0),
               jnp.where(hit, o.y + t_hit * d.y, 0.0),
               jnp.where(hit, o.z + t_hit * d.z, 0.0))
        n = _normal_at(distance_fn, p)
        return n.x, n.y, n.z

    zero = t_hit * 0.0
    n = jax.lax.cond(_any(hit), normal, lambda: (zero, zero, zero))
    return t_hit, n


def _kernel(distance_fn, cull_backface, escape_bound, relax, unroll,
            scale_ref, steps_ref, capped_ref,
            ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            gate_ref, tlo_ref, thi_ref,
            thit_ref, nx_ref, ny_ref, nz_ref):
    gate = gate_ref[...] != 0
    inf = jnp.float32(jnp.inf)

    def run():
        o = V3(ox_ref[...], oy_ref[...], oz_ref[...])
        d = V3(dx_ref[...], dy_ref[...], dz_ref[...])
        t_hit, n = _march_block(
            distance_fn, o, d, gate, tlo_ref[...], thi_ref[...],
            scale_ref[0], steps_ref[0], capped_ref[0],
            cull_backface=cull_backface, escape_bound=escape_bound,
            relax=relax, unroll=unroll,
        )
        return (t_hit,) + tuple(n)

    def skip():
        zero = jnp.zeros(gate.shape, jnp.float32)
        return zero + inf, zero, zero, zero

    t_hit, nx, ny, nz = jax.lax.cond(_any(gate), run, skip)
    thit_ref[...] = t_hit
    nx_ref[...] = nx
    ny_ref[...] = ny
    nz_ref[...] = nz


def _to_lanes(x, fill):
    """Batch plane -> flat lanes. A 2-D (H, W) batch is padded to whole
    tiles and each run of BLOCK lanes is one TILE of the screen (reshape +
    transpose, which XLA fuses into the producer); other batches keep their
    row-major order."""
    if x.ndim != 2:
        return x.reshape(-1)
    th, tw = TILE
    h, w = x.shape
    x = jnp.pad(x, ((0, -h % th), (0, -w % tw)), constant_values=fill)
    hp, wp = x.shape
    return x.reshape(hp // th, th, wp // tw, tw).transpose(0, 2, 1, 3).reshape(-1)


def _from_lanes(x, shape):
    if len(shape) != 2:
        return x[: math.prod(shape)].reshape(shape)
    th, tw = TILE
    h, w = shape
    hp, wp = h + (-h % th), w + (-w % tw)
    x = x[: hp * wp].reshape(hp // th, wp // tw, th, tw).transpose(0, 2, 1, 3)
    return x.reshape(hp, wp)[:h, :w]


@functools.partial(
    jax.jit,
    static_argnames=("prim_code", "cull_backface", "escape_bound", "relax",
                     "interpret"),
)
def sphere_trace_lanes(
    origins,  # (..., 3) local-space
    directions,  # (..., 3)
    gate,  # (...) bool: lanes to march (the AABB gate & active mask)
    t_min,  # (...) or scalar: march start (and lower end of valid hits)
    t_max,  # (...) or scalar: upper end of valid hits
    step_scale,  # scalar f32
    max_steps,  # scalar int (may be traced: per-level budgets)
    capped_hit=False,  # scalar bool (may be traced)
    *,
    prim_code: int,
    cull_backface: bool = True,
    escape_bound: bool = True,
    relax: float = 1.0,
    interpret: bool = False,
):
    """Per-lane Triton sphere trace with the semantics of sdf.sphere_trace
    (t_min there is the march start here). Returns (hit, t_hit, normal)."""
    distance_fn = DISTANCE_FUNCTIONS_SOA[int(prim_code)]
    shape = gate.shape
    f32 = jnp.float32

    def plane(x, fill, dtype=f32):
        return _to_lanes(jnp.broadcast_to(jnp.asarray(x, dtype), shape), fill)

    planes = [
        plane(origins[..., 0], 0.0), plane(origins[..., 1], 0.0),
        plane(origins[..., 2], 0.0), plane(directions[..., 0], 1.0),
        plane(directions[..., 1], 0.0), plane(directions[..., 2], 0.0),
        plane(gate, 0, jnp.int32), plane(t_min, 0.0), plane(t_max, 0.0),
    ]
    n = planes[0].shape[0]
    pad = -n % BLOCK
    if pad:
        fills = (0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0, 0.0, 0.0)
        planes = [jnp.pad(p, (0, pad), constant_values=f)
                  for p, f in zip(planes, fills)]
    lanes = n + pad
    scalars = [
        jnp.reshape(jnp.asarray(step_scale, f32), (1,)),
        jnp.reshape(jnp.asarray(max_steps, jnp.int32), (1,)),
        jnp.reshape(jnp.asarray(capped_hit).astype(jnp.int32), (1,)),
    ]

    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    scalar_spec = pl.BlockSpec((1,), lambda i: (0,))
    # Declare the outputs varying like the rays so the kernel also runs
    # under shard_map.
    vma = getattr(jax.typeof(planes[0]), "vma", None)
    out = jax.ShapeDtypeStruct((lanes,), f32, **({"vma": vma} if vma else {}))
    kernel = functools.partial(
        _kernel, distance_fn, bool(cull_backface), bool(escape_bound),
        float(relax), UNROLL,
    )
    thit, nx, ny, nz = pl.pallas_call(
        kernel,
        grid=(lanes // BLOCK,),
        in_specs=[scalar_spec] * 3 + [lane_spec] * 9,
        out_specs=[lane_spec] * 4,
        out_shape=[out] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name=f"sdf_march_{int(prim_code)}",
    )(*scalars, *planes)

    thit = _from_lanes(thit, shape)
    normal = jnp.stack([_from_lanes(c, shape) for c in (nx, ny, nz)], axis=-1)
    return jnp.isfinite(thit), thit, normal
