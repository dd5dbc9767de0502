"""THE built-in scene: checkerboard ground plane + 4x1x4 grid of procedural
primitives, with every material/placement constant from the reference.

Reference anchors:
  materials               Renderer.cpp:201-250
  camera                  Renderer.cpp:252-268 (eye (0,5.3,-17), look at origin,
                          45deg initial Y rotation, fov 45, near 0.01 far 125)
  light                   Renderer.cpp:270-286 ((0,18,-20), ambient 0.25, diffuse 0.6)
  AABB grid placement     Renderer.cpp:484-536 (4x1x4 cells, width 2, spacing 2)
  plane instance          Renderer.cpp:742-765 (700x1x700 AABB-widths, offset -0.35*width)
  AABB instance +1 in Y   Renderer.cpp:778-781
  per-frame transforms    Renderer.cpp:302-356
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from gpuraytracer.accel import bvh as _bvh
from gpuraytracer.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer.core.camera import Camera
from gpuraytracer.core.types import (
    AnalyticPrimitive,
    CHROMIUM_REFLECTANCE,
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    SceneConstants,
    SignedDistancePrimitive,
    TOTAL_PRIMITIVE_COUNT,
    VolumetricPrimitive,
    make_scene_constants,
)

# ---------------------------------------------------------------------------
# Grid constants (Renderer.h:95-96, Renderer.cpp:490-497)
# ---------------------------------------------------------------------------

AABB_WIDTH = 2.0
AABB_DISTANCE = 2.0
_GRID = (4, 1, 4)
_STRIDE = AABB_WIDTH + AABB_DISTANCE  # 4.0
_BASE = tuple(
    -(n * AABB_WIDTH + (n - 1) * AABB_DISTANCE) / 2.0 for n in _GRID
)  # (-7, -1, -7)


def _aabb(offset_index, size):
    """initialize_aabb (Renderer.cpp:498-504): min = base + idx*stride,
    max = min + size. offset_index may be fractional (SquareTorus, Spheres)."""
    mn = tuple(_BASE[k] + offset_index[k] * _STRIDE for k in range(3))
    mx = tuple(mn[k] + size[k] for k in range(3))
    return mn, mx


# Geometry order == shader-record order: Analytic(2), Volumetric(1), SDF(7)
# (RaytracingSceneDefines.h:113-143). Names are for logs/tests.
GEOMETRY_NAMES = (
    "analytic_aabb",
    "analytic_spheres",
    "metaballs",
    "sdf_mini_spheres",
    "sdf_intersected_round_cube",
    "sdf_square_torus",
    "sdf_twisted_torus",
    "sdf_cog",
    "sdf_cylinder",
    "sdf_fractal_pyramid",
)

LAYOUT = SceneLayout(
    kinds=(
        IntersectorKind.ANALYTIC,
        IntersectorKind.ANALYTIC,
        IntersectorKind.VOLUMETRIC,
        IntersectorKind.SIGNED_DISTANCE,
        IntersectorKind.SIGNED_DISTANCE,
        IntersectorKind.SIGNED_DISTANCE,
        IntersectorKind.SIGNED_DISTANCE,
        IntersectorKind.SIGNED_DISTANCE,
        IntersectorKind.SIGNED_DISTANCE,
        IntersectorKind.SIGNED_DISTANCE,
    ),
    prim_types=(
        int(AnalyticPrimitive.AABB),
        int(AnalyticPrimitive.SPHERES),
        int(VolumetricPrimitive.METABALLS),
        int(SignedDistancePrimitive.MINI_SPHERES),
        int(SignedDistancePrimitive.INTERSECTED_ROUND_CUBE),
        int(SignedDistancePrimitive.SQUARE_TORUS),
        int(SignedDistancePrimitive.TWISTED_TORUS),
        int(SignedDistancePrimitive.COG),
        int(SignedDistancePrimitive.CYLINDER),
        int(SignedDistancePrimitive.FRACTAL_PYRAMID),
    ),
    has_plane=True,
)

# AABB placements (Renderer.cpp:508-533), in geometry order.
_AABBS = (
    _aabb((3, 0, 0), (2, 3, 2)),  # AnalyticPrimitive::AABB
    _aabb((2.25, 0, 0.75), (3, 3, 3)),  # AnalyticPrimitive::Spheres
    _aabb((0, 0, 0), (3, 3, 3)),  # VolumetricPrimitive::Metaballs
    _aabb((2, 0, 0), (2, 2, 2)),  # MiniSpheres
    _aabb((0, 0, 2), (2, 2, 2)),  # IntersectedRoundCube
    _aabb((0.75, -0.1, 2.25), (3, 3, 3)),  # SquareTorus
    _aabb((0, 0, 1), (2, 2, 2)),  # TwistedTorus
    _aabb((1, 0, 0), (2, 2, 2)),  # Cog
    _aabb((0, 0, 3), (2, 3, 2)),  # Cylinder
    _aabb((2, 0, 2), (6, 6, 6)),  # FractalPyramid
)

AABB_MIN = np.asarray([a[0] for a in _AABBS], dtype=np.float32)
AABB_MAX = np.asarray([a[1] for a in _AABBS], dtype=np.float32)

# Procedural BLAS instance translation: all AABBs +aabb_width/2 in Y
# (Renderer.cpp:778-781).
BLAS_OFFSET = (0.0, AABB_WIDTH / 2.0, 0.0)

# Per-frame transform specs (Renderer.cpp:302-356): (scale xyz, rotates?).
TRANSFORM_SPECS: Tuple[Tuple[Tuple[float, float, float], bool], ...] = (
    ((1.0, 1.5, 1.0), False),  # AABB: m_scale_15_y, identity
    ((1.5, 1.5, 1.5), True),  # Spheres: m_scale_15, rotation
    ((1.5, 1.5, 1.5), True),  # Metaballs: m_scale_15, rotation
    ((1.0, 1.0, 1.0), False),  # MiniSpheres
    ((1.0, 1.0, 1.0), False),  # IntersectedRoundCube
    ((1.5, 1.5, 1.5), False),  # SquareTorus
    ((1.0, 1.0, 1.0), True),  # TwistedTorus
    ((1.0, 1.0, 1.0), True),  # Cog
    ((1.0, 1.5, 1.0), False),  # Cylinder: m_scale_15_y
    ((3.0, 3.0, 3.0), False),  # FractalPyramid: m_scale_3
)

ROTATION_RATE = -2.0  # radians per second (Renderer.cpp:311)

# ---------------------------------------------------------------------------
# Materials (Renderer.cpp:201-250); plane material appended as the last row.
# ---------------------------------------------------------------------------

_GREEN = (0.1, 1.0, 0.5, 1.0)
_RED = (1.0, 0.5, 0.5, 1.0)
_YELLOW = (1.0, 1.0, 0.5, 1.0)


def _mat(albedo, reflectance=0.0, diffuse=0.9, specular=0.7, power=50.0, step_scale=1.0):
    return (albedo, reflectance, diffuse, specular, power, step_scale)


_MATERIALS = (
    _mat(_RED),  # AnalyticPrimitive::AABB
    _mat(CHROMIUM_REFLECTANCE, 1.0),  # Spheres
    _mat(CHROMIUM_REFLECTANCE, 1.0),  # Metaballs
    _mat(_GREEN),  # MiniSpheres
    _mat(_GREEN),  # IntersectedRoundCube
    _mat(CHROMIUM_REFLECTANCE, 1.0),  # SquareTorus
    _mat(_YELLOW, 0.0, 1.0, 0.7, 50.0, 0.5),  # TwistedTorus
    _mat(_YELLOW, 0.0, 1.0, 0.1, 2.0),  # Cog
    _mat(_RED),  # Cylinder
    _mat(_GREEN, 0.0, 1.0, 0.1, 4.0, 0.8),  # FractalPyramid
    # Plane (Renderer.cpp:215): albedo 0.9, refl 0.25, diffuse 1, spec 0.4,
    # power 50, step 1.
    ((0.9, 0.9, 0.9, 1.0), 0.25, 1.0, 0.4, 50.0, 1.0),
)

PLANE_GEOMETRY_ID = TOTAL_PRIMITIVE_COUNT  # 10


def material_table() -> MaterialTable:
    return MaterialTable(
        albedo=jnp.asarray([m[0] for m in _MATERIALS], dtype=jnp.float32),
        reflectance_coefficient=jnp.asarray([m[1] for m in _MATERIALS], dtype=jnp.float32),
        diffuse_coefficient=jnp.asarray([m[2] for m in _MATERIALS], dtype=jnp.float32),
        specular_coefficient=jnp.asarray([m[3] for m in _MATERIALS], dtype=jnp.float32),
        specular_power=jnp.asarray([m[4] for m in _MATERIALS], dtype=jnp.float32),
        step_scale=jnp.asarray([m[5] for m in _MATERIALS], dtype=jnp.float32),
    )


# ---------------------------------------------------------------------------
# Plane instance (Renderer.cpp:742-765): 700x1x700 AABB-widths scaled quad,
# offset (-0.35, 0, -0.35) * width. Vertices span [0,1] in x/z at y == 0.
# ---------------------------------------------------------------------------

_PLANE_N = (700, 1, 700)
PLANE_WIDTH = tuple(
    n * AABB_WIDTH + (n - 1) * AABB_DISTANCE for n in _PLANE_N
)  # (2798, 2, 2798)
PLANE_ORIGIN = (
    PLANE_WIDTH[0] * -0.35,
    0.0,
    PLANE_WIDTH[2] * -0.35,
)  # (-979.3, 0, -979.3)
PLANE_SIZE = (PLANE_WIDTH[0], PLANE_WIDTH[2])

# ---------------------------------------------------------------------------
# Lights (Renderer.cpp:270-286)
# ---------------------------------------------------------------------------

LIGHT_POSITION = (0.0, 18.0, -20.0, 0.0)
LIGHT_AMBIENT = (0.25, 0.25, 0.25, 1.0)
LIGHT_DIFFUSE = (0.6, 0.6, 0.6, 1.0)


def default_camera() -> Camera:
    return Camera(eye=(0.0, 5.3, -17.0), at=(0.0, 0.0, 0.0), initial_y_rotation_deg=45.0)


# Near-to-camera-first geometry processing order for the tile kernels
# (SceneLayout.traversal_order): the default camera position is static
# (orbit off by default, Renderer.cpp:46), so the order is a build-time
# constant. Eye moves into BLAS space (ray_to_blas subtracts the
# translation) to match the AABB tables.
_EYE_BLAS = np.asarray(default_camera().eye) - np.asarray(BLAS_OFFSET)
_D2 = (((AABB_MIN + AABB_MAX) * 0.5 - _EYE_BLAS.astype(np.float32)) ** 2).sum(axis=1)
# Closed-form analytic tests are near-free: run them all first to bound t
# before any march, then marches near-to-far.
LAYOUT = dataclasses.replace(
    LAYOUT,
    traversal_order=tuple(sorted(
        range(len(LAYOUT.kinds)),
        key=lambda i: (LAYOUT.kinds[i] != IntersectorKind.ANALYTIC, _D2[i]),
    )),
    # Two-level bounds hierarchy (accel/bvh.py): 8 of the 10 instances are
    # march kinds, over the MARCH_FLAT_THRESHOLD, so the scene clusters at
    # the march leaf width, so edge tiles can skip whole march groups on
    # one merged-slab test.
    clusters=_bvh.build_clusters(
        AABB_MIN, AABB_MAX, leaf_size=_bvh.MARCH_LEAF_SIZE
    ),
)


def build_instance_transforms(elapsed_time) -> InstanceTransforms:
    """update_aabb_primitive_attributes (Renderer.cpp:302-356) as a pure
    function of the animation time. Matrices are column-convention (see
    core/types.py); the inverse is analytic (S^-1 R^-1 T^-1) rather than a
    numeric 4x4 inversion — same transform, better conditioning."""
    t = jnp.asarray(elapsed_time, dtype=jnp.float32)
    theta = ROTATION_RATE * t
    c, s = jnp.cos(theta), jnp.sin(theta)

    centers = (AABB_MIN + AABB_MAX) * 0.5  # translation = AABB center

    l2b_rows = []
    b2l_rows = []
    eye3 = jnp.eye(3, dtype=jnp.float32)
    for i, (scale, rotates) in enumerate(TRANSFORM_SPECS):
        sx, sy, sz = scale
        if rotates:
            # Column-convention equivalent of XMMatrixRotationY(theta) for
            # row vectors: x' = c x + s z, z' = -s x + c z.
            rot = jnp.stack(
                [
                    jnp.stack([c, jnp.zeros_like(c), s]),
                    jnp.asarray([0.0, 1.0, 0.0], dtype=jnp.float32),
                    jnp.stack([-s, jnp.zeros_like(c), c]),
                ]
            )
            rot_inv = rot.T
        else:
            rot = eye3
            rot_inv = eye3
        a = rot * jnp.asarray(scale, dtype=jnp.float32)  # R @ diag(scale)
        a_inv = rot_inv / jnp.asarray(scale, dtype=jnp.float32)[:, None]

        center = jnp.asarray(centers[i], dtype=jnp.float32)
        l2b = jnp.zeros((4, 4), dtype=jnp.float32)
        l2b = l2b.at[:3, :3].set(a).at[:3, 3].set(center).at[3, 3].set(1.0)
        # Explicit matvec: `a_inv @ center` is a dot_general, which may
        # run in TF32 on the GPU — corrupting the b2l translation row (and
        # so every march) by ~1e-3 relative. Scalar multiply-adds keep f32
        # off TF32 and stay exact f32 everywhere.
        tcol = -(a_inv[:, 0] * center[0] + a_inv[:, 1] * center[1]
                 + a_inv[:, 2] * center[2])
        b2l = jnp.zeros((4, 4), dtype=jnp.float32)
        b2l = b2l.at[:3, :3].set(a_inv).at[:3, 3].set(tcol).at[3, 3].set(1.0)
        l2b_rows.append(l2b)
        b2l_rows.append(b2l)

    return InstanceTransforms(
        local_to_blas=jnp.stack(l2b_rows), blas_to_local=jnp.stack(b2l_rows)
    )


def build_scene_constants(
    camera: Camera, aspect: float, elapsed_time=0.0, light_position=LIGHT_POSITION
) -> SceneConstants:
    return make_scene_constants(
        projection_to_world=camera.projection_to_world(aspect).astype(np.float32),
        camera_position=tuple(camera.eye) + (1.0,),
        light_position=light_position,
        light_ambient_color=LIGHT_AMBIENT,
        light_diffuse_color=LIGHT_DIFFUSE,
        reflectance=0.0,
        elapsed_time=elapsed_time,
    )


def animate_arrays(arrays: SceneArrays, elapsed_time) -> SceneArrays:
    """Advance the traced per-frame state to `elapsed_time` — the
    on_update work (update_aabb_primitive_attributes + elapsed_time upload,
    Renderer.cpp:112-119) as a pure jittable function, so the frame loop
    dispatches ONE program per frame instead of dozens of eager host ops."""
    t = jnp.asarray(elapsed_time, dtype=jnp.float32)
    constants = dataclasses.replace(arrays.constants, elapsed_time=t)
    return dataclasses.replace(
        arrays,
        constants=constants,
        transforms=build_instance_transforms(t),
    )


def build_scene(aspect: float, elapsed_time=0.0, camera: Camera | None = None,
                light_position=LIGHT_POSITION) -> Scene:
    """Assemble the full reference scene at a given animation time."""
    camera = camera or default_camera()
    arrays = SceneArrays(
        constants=build_scene_constants(camera, aspect, elapsed_time, light_position),
        materials=material_table(),
        transforms=build_instance_transforms(elapsed_time),
        aabb_min=jnp.asarray(AABB_MIN),
        aabb_max=jnp.asarray(AABB_MAX),
        blas_offset=jnp.asarray(BLAS_OFFSET, dtype=jnp.float32),
        plane_origin=jnp.asarray(
            (PLANE_ORIGIN[0], PLANE_ORIGIN[1], PLANE_ORIGIN[2]), dtype=jnp.float32
        ),
        plane_size=jnp.asarray(PLANE_SIZE, dtype=jnp.float32),
    )
    return Scene(layout=LAYOUT, arrays=arrays)
