"""Intersector registry — the shader-binding-table analog.

The reference routes rays to intersection shaders via SBT records
(Renderer.cpp:839-985, hit-group index arithmetic in
ConstantBuffers.h:106-132). Here the registry maps (IntersectorKind,
primitive type) -> intersection kernel. Built scenes dispatch STATICALLY
(accel/traverse.py unrolls over instances, so XLA compiles exactly the
kernels the scene uses); `intersect_switch` is the dynamic lax.switch form
for APIs where the type code is a traced value.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from gpuraytracer.core.types import (
    AnalyticPrimitive,
    IntersectorKind,
    SignedDistancePrimitive,
    VolumetricPrimitive,
)
from gpuraytracer.geometry import analytic, metaballs, sdf

# (kind, prim_type) -> callable(o_loc, d_loc, *, t_min, t_max, cull_backface,
#                               step_scale, elapsed_time, active)
_REGISTRY: Dict[Tuple[IntersectorKind, int], Callable] = {}


def register(kind: IntersectorKind, prim_type: int):
    def deco(fn):
        _REGISTRY[(kind, int(prim_type))] = fn
        return fn

    return deco


def lookup(kind: IntersectorKind, prim_type: int) -> Callable:
    return _REGISTRY[(IntersectorKind(kind), int(prim_type))]


def registered() -> Tuple[Tuple[IntersectorKind, int], ...]:
    return tuple(sorted(_REGISTRY.keys()))


@register(IntersectorKind.ANALYTIC, AnalyticPrimitive.AABB)
def _aabb(o, d, *, t_min, t_max, cull_backface, step_scale, elapsed_time, active):
    return analytic.intersect_hollow_aabb(
        o, d, t_min=t_min, t_max=t_max, cull_backface=cull_backface
    )


@register(IntersectorKind.ANALYTIC, AnalyticPrimitive.SPHERES)
def _spheres(o, d, *, t_min, t_max, cull_backface, step_scale, elapsed_time, active):
    return analytic.intersect_spheres(
        o, d, t_min=t_min, t_max=t_max, cull_backface=cull_backface
    )


@register(IntersectorKind.VOLUMETRIC, VolumetricPrimitive.METABALLS)
def _metaballs(o, d, *, t_min, t_max, cull_backface, step_scale, elapsed_time, active):
    return metaballs.intersect_metaballs(
        o, d, elapsed_time, t_min=t_min, t_max=t_max,
        cull_backface=cull_backface, active=active,
    )


def _make_sdf(prim_code: int):
    distance_fn = sdf.DISTANCE_FUNCTIONS[int(prim_code)]

    def _fn(o, d, *, t_min, t_max, cull_backface, step_scale, elapsed_time, active):
        return sdf.sphere_trace(
            o, d, distance_fn, step_scale=step_scale, t_min=t_min, t_max=t_max,
            cull_backface=cull_backface, active=active,
        )

    return _fn


from gpuraytracer.geometry import fractal as _fractal  # noqa: E402 (registers extended SDFs)

for _code in sorted(sdf.DISTANCE_FUNCTIONS):
    register(IntersectorKind.SIGNED_DISTANCE, _code)(_make_sdf(_code))


def intersect_switch(
    kind_and_type_code,  # traced int32: dense code into `registered()` order
    o,
    d,
    *,
    t_min,
    t_max,
    cull_backface,
    step_scale,
    elapsed_time,
    active,
):
    """Dynamic dispatch over every registered intersector via lax.switch —
    for scenes whose geometry types are runtime data. Costs all branches'
    code size; built scenes should prefer the static unroll."""
    entries = registered()

    def make_branch(key):
        fn = _REGISTRY[key]

        def branch(_):
            return fn(
                o, d, t_min=t_min, t_max=t_max, cull_backface=cull_backface,
                step_scale=step_scale, elapsed_time=elapsed_time, active=active,
            )

        return branch

    return jax.lax.switch(
        jnp.asarray(kind_and_type_code, dtype=jnp.int32),
        [make_branch(k) for k in entries],
        None,
    )


def dense_code(kind: IntersectorKind, prim_type: int) -> int:
    """Index of (kind, prim_type) in the lax.switch branch order."""
    return registered().index((IntersectorKind(kind), int(prim_type)))
