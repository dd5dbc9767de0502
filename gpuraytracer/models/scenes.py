"""The five benchmark scenes from BASELINE.json configs #1-#5.

1. Single analytic sphere + ground plane, primary+shadow, 256x256
   (CPU-backend == the WARP software device analog)
2. Analytic grid (spheres + AABBs), Phong + 1-bounce reflections, 720p
3. SignedDistancePrimitives showcase (all 7 sphere-traced objects), 720p
4. Animated metaballs, time-stepped frames, 1080p
5. Mandelbulb + quaternion-Julia fractal scene, reflections + shadows,
   1080p (framework extension — the reference's only fractal is the
   pyramid; see geometry/fractal.py)

Each entry returns (name, SceneBuilder-produced scene factory, width,
height, max_depth). Factories take (aspect, elapsed_time) so animation
benchmarking reuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

from gpuraytracer.core.types import (
    AnalyticPrimitive,
    CHROMIUM_REFLECTANCE,
    IntersectorKind,
    SignedDistancePrimitive,
    VolumetricPrimitive,
)
from gpuraytracer.geometry.fractal import ExtendedSignedDistancePrimitive
from gpuraytracer.models.builder import (
    InstanceSpec,
    Material,
    SceneBuilder,
    grid_cell_aabb,
)

GREEN = (0.1, 1.0, 0.5, 1.0)
RED = (1.0, 0.5, 0.5, 1.0)
YELLOW = (1.0, 1.0, 0.5, 1.0)
CHROME = Material(CHROMIUM_REFLECTANCE, reflectance=1.0)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    build: Callable[[float, float], object]  # (aspect, t) -> Scene
    width: int
    height: int
    max_depth: int
    animated: bool = False
    builder: Callable[[], SceneBuilder] = None  # fresh SceneBuilder factory


def _single_sphere_builder() -> SceneBuilder:
    b = SceneBuilder()
    mn, mx = grid_cell_aabb(1, 1, size=(3.0, 3.0, 3.0))
    b.add_instance(
        InstanceSpec(
            kind=IntersectorKind.ANALYTIC,
            prim_type=int(AnalyticPrimitive.SPHERES),
            aabb_min=mn,
            aabb_max=mx,
            material=Material(RED),  # non-reflective: primary + shadow only
            scale=(1.5, 1.5, 1.5),
        )
    )
    return b


def _analytic_grid_builder() -> SceneBuilder:
    b = SceneBuilder()
    for ix in range(4):
        for iz in range(4):
            if (ix + iz) % 2 == 0:
                b.add_instance(
                    InstanceSpec(
                        kind=IntersectorKind.ANALYTIC,
                        prim_type=int(AnalyticPrimitive.SPHERES),
                        aabb_min=grid_cell_aabb(ix, iz, (3, 3, 3))[0],
                        aabb_max=grid_cell_aabb(ix, iz, (3, 3, 3))[1],
                        material=CHROME,
                        scale=(1.5, 1.5, 1.5),
                        rotates=True,
                    )
                )
            else:
                b.add_instance(
                    InstanceSpec(
                        kind=IntersectorKind.ANALYTIC,
                        prim_type=int(AnalyticPrimitive.AABB),
                        aabb_min=grid_cell_aabb(ix, iz, (2, 3, 2))[0],
                        aabb_max=grid_cell_aabb(ix, iz, (2, 3, 2))[1],
                        material=Material(RED if iz % 2 else YELLOW),
                        scale=(1.0, 1.5, 1.0),
                    )
                )
    return b


_SDF_OBJECTS = (
    (SignedDistancePrimitive.MINI_SPHERES, Material(GREEN), (1, 1, 1), False),
    (SignedDistancePrimitive.INTERSECTED_ROUND_CUBE, Material(GREEN), (1, 1, 1), False),
    (SignedDistancePrimitive.SQUARE_TORUS, CHROME, (1.5, 1.5, 1.5), False),
    (SignedDistancePrimitive.TWISTED_TORUS, Material(YELLOW, 0, 1.0, 0.7, 50, 0.5), (1, 1, 1), True),
    (SignedDistancePrimitive.COG, Material(YELLOW, 0, 1.0, 0.1, 2), (1, 1, 1), True),
    (SignedDistancePrimitive.CYLINDER, Material(RED), (1, 1.5, 1), False),
    (SignedDistancePrimitive.FRACTAL_PYRAMID, Material(GREEN, 0, 1, 0.1, 4, 0.8), (3, 3, 3), False),
)


def _sdf_showcase_builder() -> SceneBuilder:
    b = SceneBuilder()
    cells = [(0, 0), (1, 0), (2, 0), (0, 2), (1, 2), (2, 2), (3, 1)]
    for (prim, mat, scale, rotates), (ix, iz) in zip(_SDF_OBJECTS, cells):
        size = (6.0, 6.0, 6.0) if prim == SignedDistancePrimitive.FRACTAL_PYRAMID else (
            (2.0 * scale[0], 2.0 * scale[1], 2.0 * scale[2])
        )
        mn, mx = grid_cell_aabb(ix, iz, size)
        b.add_instance(
            InstanceSpec(
                kind=IntersectorKind.SIGNED_DISTANCE,
                prim_type=int(prim),
                aabb_min=mn,
                aabb_max=mx,
                material=mat,
                scale=scale,
                rotates=rotates,
            )
        )
    return b


def _metaballs_builder() -> SceneBuilder:
    b = SceneBuilder()
    for ix, iz in ((0, 1), (2, 1), (1, 3)):
        mn, mx = grid_cell_aabb(ix, iz, (3, 3, 3))
        b.add_instance(
            InstanceSpec(
                kind=IntersectorKind.VOLUMETRIC,
                prim_type=int(VolumetricPrimitive.METABALLS),
                aabb_min=mn,
                aabb_max=mx,
                material=CHROME,
                scale=(1.5, 1.5, 1.5),
                rotates=True,
            )
        )
    return b


def _fractal_builder() -> SceneBuilder:
    b = SceneBuilder()
    mb_min, mb_max = grid_cell_aabb(1, 1, (4, 4, 4))
    b.add_instance(
        InstanceSpec(
            kind=IntersectorKind.SIGNED_DISTANCE,
            prim_type=int(ExtendedSignedDistancePrimitive.MANDELBULB),
            aabb_min=mb_min,
            aabb_max=mb_max,
            material=Material(GREEN, 0.0, 1.0, 0.4, 10.0, 0.6),
            scale=(2.0, 2.0, 2.0),
            rotates=True,
            # DE fractals get their own march budget (VERDICT r1 item 3):
            # the Mandelbulb estimator converges in far fewer steps than the
            # reference primitives' 512; at 192 the 96x54 render keeps 98.8%
            # of pixels within 1e-3 of the 512-step image (tools note in
            # DEVNOTES), the rest are silhouette hit/miss flips. The
            # over-relaxed march (sdf.extension_relax) reaches the same
            # depth in ~omega-fold fewer steps: at 128 the relaxed render
            # keeps 99.46% within 1e-3 of the relaxed 192-step image
            # (budget sweep, DEVNOTES round 3). Round 5: 96 under the
            # capped=>occluded semantics moves 0.325% of pixels vs
            # uncapped (320x180 A/B) — inside the 0.5% standard.
            step_budget=96,
        )
    )
    jl_min, jl_max = grid_cell_aabb(3, 2, (4, 4, 4))
    b.add_instance(
        InstanceSpec(
            kind=IntersectorKind.SIGNED_DISTANCE,
            prim_type=int(ExtendedSignedDistancePrimitive.JULIA_QUATERNION),
            aabb_min=jl_min,
            aabb_max=jl_max,
            material=Material(YELLOW, 0.0, 1.0, 0.4, 10.0, 0.6),
            scale=(2.0, 2.0, 2.0),
            rotates=True,
            step_budget=96,
        )
    )
    # A chromium mirror sphere cluster for the "reflections" requirement.
    sp_min, sp_max = grid_cell_aabb(0, 3, (3, 3, 3))
    b.add_instance(
        InstanceSpec(
            kind=IntersectorKind.ANALYTIC,
            prim_type=int(AnalyticPrimitive.SPHERES),
            aabb_min=sp_min,
            aabb_max=sp_max,
            material=CHROME,
            scale=(1.5, 1.5, 1.5),
        )
    )
    return b


def _factory(builder_fn):
    def build(aspect: float, elapsed_time: float = 0.0):
        return builder_fn().build(aspect, elapsed_time)

    return build


BENCH_CONFIGS: Tuple[BenchConfig, ...] = (
    BenchConfig("single_sphere_plane_256", _factory(_single_sphere_builder), 256, 256, 2,
                builder=_single_sphere_builder),
    BenchConfig("analytic_grid_720p", _factory(_analytic_grid_builder), 1280, 720, 2,
                builder=_analytic_grid_builder),
    BenchConfig("sdf_primitives_720p", _factory(_sdf_showcase_builder), 1280, 720, 3,
                builder=_sdf_showcase_builder),
    BenchConfig("metaballs_1080p", _factory(_metaballs_builder), 1920, 1080, 3,
                animated=True, builder=_metaballs_builder),
    BenchConfig("fractal_mandelbulb_julia_1080p", _factory(_fractal_builder), 1920, 1080, 3,
                builder=_fractal_builder),
)


def get_config(name: str) -> BenchConfig:
    for c in BENCH_CONFIGS:
        if c.name == name:
            return c
    raise KeyError(name)
