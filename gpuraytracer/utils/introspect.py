"""Pipeline introspection — the print_state_object_desc / shader-table
DebugPrint analog (RendererRaytracingHelper.h:551-660, 472-489;
SURVEY.md §4 "Debug introspection").

Where the reference pretty-prints the RTPSO subobjects and SBT records,
this renders the compiled dispatch structure: geometry table (kind,
primitive, intersector route), material records, and execution backend.
"""

from __future__ import annotations

from gpuraytracer.accel.instances import Scene
from gpuraytracer.core.types import (
    AnalyticPrimitive,
    IntersectorKind,
    SignedDistancePrimitive,
    VolumetricPrimitive,
)


def _prim_name(kind: IntersectorKind, code: int) -> str:
    try:
        if kind == IntersectorKind.ANALYTIC:
            return AnalyticPrimitive(code).name
        if kind == IntersectorKind.VOLUMETRIC:
            return VolumetricPrimitive(code).name
        if kind == IntersectorKind.SIGNED_DISTANCE:
            if code <= int(SignedDistancePrimitive.FRACTAL_PYRAMID):
                return SignedDistancePrimitive(code).name
            from gpuraytracer.geometry.fractal import (
                ExtendedSignedDistancePrimitive,
            )

            return ExtendedSignedDistancePrimitive(code).name
    except ValueError:
        pass
    return f"type_{code}"


def describe_scene(scene: Scene) -> str:
    """Human-readable dump of the dispatch structure (the SBT listing)."""
    import numpy as np

    layout = scene.layout
    mats = scene.arrays.materials
    albedo = np.asarray(mats.albedo)
    refl = np.asarray(mats.reflectance_coefficient)
    step = np.asarray(mats.step_scale)

    lines = [
        f"scene: {layout.num_procedural} procedural geometr"
        f"{'y' if layout.num_procedural == 1 else 'ies'}"
        f"{' + ground plane' if layout.has_plane else ''}",
        f"{'id':>3} {'kind':<16} {'primitive':<24} {'albedo':<26} "
        f"{'refl':>5} {'step':>5}",
    ]
    for i, (kind, code) in enumerate(zip(layout.kinds, layout.prim_types)):
        a = albedo[i]
        lines.append(
            f"{i:>3} {IntersectorKind(kind).name:<16} "
            f"{_prim_name(kind, code):<24} "
            f"({a[0]:.3f}, {a[1]:.3f}, {a[2]:.3f}, {a[3]:.3f}) "
            f"{refl[i]:>5.2f} {step[i]:>5.2f}"
        )
    if layout.has_plane:
        i = layout.plane_geometry_id
        a = albedo[i]
        lines.append(
            f"{i:>3} {'TRIANGLE':<16} {'GROUND_PLANE':<24} "
            f"({a[0]:.3f}, {a[1]:.3f}, {a[2]:.3f}, {a[3]:.3f}) "
            f"{refl[i]:>5.2f} {step[i]:>5.2f}"
        )
    return "\n".join(lines)


def describe_backend() -> str:
    """Which compute path traversal will take on this host."""
    import jax

    from gpuraytracer.kernels import sdf_march

    backend = jax.default_backend()
    march = (
        f"Triton per-lane march ({sdf_march.BLOCK}-lane blocks)"
        if backend == "gpu" else "XLA while loops"
    )
    return f"backend={backend}; traversal=XLA wavefront, SDF march={march}"
