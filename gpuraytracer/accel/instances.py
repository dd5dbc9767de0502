"""Flattened two-level scene structure — the TLAS/BLAS replacement.

The reference builds driver-internal DXR acceleration structures over
2 BLASes (1 triangle plane + 10 procedural AABB geometries) and a 2-instance
TLAS (Renderer.cpp:478-835). At 11 geometries, hardware BVH traversal is
replaced by a branchless slab test of every ray against every instance AABB
(trivially vectorizable); the API below is the seam where a real
LBVH slots in for bigger scenes without a rewrite (SURVEY.md §2.5).

Spaces (matching the reference exactly):
  world --(TLAS instance transform)--> BLAS space --(per-frame
  PrimitiveInstancePerFrameBuffer matrix)--> unit-AABB local space.
The AABB instance transform is a pure +Y translation (Renderer.cpp:778-781),
so the ray parameter t is shared between world and BLAS space; the per-frame
local transforms carry scale/rotation and are applied inside the
intersector dispatch, exactly like GetRayInAABBPrimitiveLocalSpace
(Raytracing.hlsl:277-287).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from gpuraytracer.core.types import (
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    SceneConstants,
)


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static (hashable, non-traced) scene structure: which intersection
    kernel each procedural geometry dispatches to. This is the
    shader-binding-table analog (SURVEY.md §2.6) — a compile-time registry
    rather than runtime indirection, so XLA sees a fully static program."""

    kinds: Tuple[IntersectorKind, ...]  # per procedural instance
    prim_types: Tuple[int, ...]  # enum value within its kind
    has_plane: bool = True
    # Optional two-level bounds hierarchy (accel/bvh.py): a static partition
    # of instance indices into spatial clusters. None = flat traversal (the
    # builtin scene's 10 instances need no hierarchy, like the reference's
    # 2-instance TLAS). Built once per scene from the static BLAS-space
    # AABBs — the driver-BLAS-build analog (Renderer.cpp:616-730).
    clusters: Tuple[Tuple[int, ...], ...] | None = None
    # Optional per-instance sphere-trace step budgets. None = the
    # reference's 512 everywhere (SignedDistancePrimitives.hlsli:291).
    # Framework-extension geometry (DE fractals) may choose smaller budgets;
    # reference primitives must keep 512 for parity.
    step_budgets: Tuple[int, ...] | None = None
    # Optional static geometry PROCESSING order (a permutation of
    # range(len(kinds))) for the tile kernels: near-to-camera first, so the
    # tile's shrinking best_t rejects far geometries' slab gates before
    # their marches run — the closest-hit reduction is order independent
    # (strict-< min; DXR traversal order is unspecified anyway). None =
    # definition order. Built once per scene from the static camera eye
    # and BLAS-space AABB centers.
    traversal_order: Tuple[int, ...] | None = None
    # Optional geometry -> material-slot map (len = num_geometries:
    # instances then plane). SceneBuilder dedups identical shading
    # materials so the kernels' material select chains run over UNIQUE
    # rows — the reference's shader table likewise points many records at
    # shared root constants (Renderer.cpp:201-250 defines ~11 materials
    # reused across instances). None = identity (material row g =
    # geometry g). step_scale stays per-geometry and is NOT deduped.
    material_ids: Tuple[int, ...] | None = None

    @property
    def num_procedural(self) -> int:
        return len(self.kinds)

    @property
    def plane_geometry_id(self) -> int:
        return len(self.kinds)

    @property
    def num_geometries(self) -> int:
        return len(self.kinds) + (1 if self.has_plane else 0)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Traced per-frame scene state (the constant-buffer contents)."""

    constants: SceneConstants
    materials: MaterialTable  # (G, ...) rows; plane material is the LAST row
    transforms: InstanceTransforms  # (P, 4, 4) pairs, rebuilt per frame
    aabb_min: Any  # (P, 3) BLAS-space geometry AABBs
    aabb_max: Any  # (P, 3)
    blas_offset: Any  # (3,) BLAS -> world translation for procedural geometry
    plane_origin: Any  # (3,) world-space corner of the ground quad
    plane_size: Any  # (2,) world-space x/z extents of the quad
    meshes: Tuple[Any, ...] = ()  # TriangleMesh per TRIANGLE instance (its
    # prim_type indexes this tuple) — the triangle BLAS vertex/index data

    def tree_flatten(self):
        children = (
            self.constants,
            self.materials,
            self.transforms,
            self.aabb_min,
            self.aabb_max,
            self.blas_offset,
            self.plane_origin,
            self.plane_size,
            self.meshes,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


@dataclasses.dataclass(frozen=True)
class Scene:
    """layout (static) + arrays (traced). Pass `layout` via closure /
    static argnum and `arrays` as a jit argument."""

    layout: SceneLayout
    arrays: SceneArrays


def ray_to_blas(origins_world, directions_world, blas_offset):
    """World -> AABB-BLAS space: subtract the instance translation
    (Renderer.cpp:778-781). Directions unchanged; t unchanged."""
    return origins_world - blas_offset, directions_world


def ray_to_local(origins_blas, directions_blas, blas_to_local):
    """BLAS -> unit-AABB local space via the per-frame inverse matrix
    (Raytracing.hlsl:277-287). blas_to_local is column-convention (4,4).
    The ray parameter t is preserved: p_local(t) = M @ p_blas(t).

    Written as EXPLICIT per-row multiply-adds rather than `v @ rot.T`: a
    (N,3)@(3,3) dot_general may run on the GPU's tensor cores in TF32,
    which keeps ~3 decimal digits and would perturb every local-space ray
    by ~1e-3 relative — cascading through the marches into |t| errors of
    0.1-2 on nearly all SDF hits. Elementwise math is exact f32 on every
    backend and associates identically on the CPU reference."""
    m = blas_to_local

    def row(r, v, w=False):
        out = (m[r, 0] * v[..., 0] + m[r, 1] * v[..., 1]
               + m[r, 2] * v[..., 2])
        return out + m[r, 3] if w else out

    o = jnp.stack([row(0, origins_blas, w=True),
                   row(1, origins_blas, w=True),
                   row(2, origins_blas, w=True)], axis=-1)
    d = jnp.stack([row(0, directions_blas), row(1, directions_blas),
                   row(2, directions_blas)], axis=-1)
    return o, d


def normal_to_world(normal_local, local_to_blas):
    """Local -> BLAS -> world normal, exactly as the intersection shaders do
    it (Raytracing.hlsl:298-301): straight matrix transform (NOT inverse
    transpose — reproduced as-is), identity for BLAS->world, then normalize.

    Explicit multiply-adds to keep f32 off TF32, as in ray_to_local
    above."""
    m = local_to_blas

    def row(r, v):
        return m[r, 0] * v[..., 0] + m[r, 1] * v[..., 1] + m[r, 2] * v[..., 2]

    n = jnp.stack([row(0, normal_local), row(1, normal_local),
                   row(2, normal_local)], axis=-1)
    return n / jnp.sqrt(
        jnp.sum(n * n, axis=-1, keepdims=True))
