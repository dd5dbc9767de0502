"""Generic scene builder — compose arbitrary procedural scenes.

The reference hardcodes one scene in Renderer::initialize_scene /
build_procedural_geometry_aabbs (Renderer.cpp:197-287, 484-536). The
builder exposes the same ingredients (instances with AABB placement,
per-instance material + transform spec, camera, light, optional ground
plane) as a composable API, producing the same Scene structure the
wavefront tracer consumes. The five BASELINE.json benchmark configs in
models/scenes.py are built with it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from gpuraytracer.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer.core.camera import Camera
from gpuraytracer.core.types import (
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    make_scene_constants,
)
from gpuraytracer.models import builtin


@dataclasses.dataclass(frozen=True)
class Material:
    """PrimitiveConstantBuffer fields with the reference's defaults
    (Renderer.cpp:203-205)."""

    albedo: Tuple[float, float, float, float]
    reflectance: float = 0.0
    diffuse: float = 0.9
    specular: float = 0.7
    specular_power: float = 50.0
    step_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    kind: IntersectorKind
    prim_type: int
    aabb_min: Tuple[float, float, float]
    aabb_max: Tuple[float, float, float]
    material: Material
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rotates: bool = False
    rotation_rate: float = builtin.ROTATION_RATE  # rad/s about +Y
    # Sphere-trace step budget. None = the reference's 512
    # (SignedDistancePrimitives.hlsli:291) — REQUIRED for reference-parity
    # primitives. Framework-extension geometry (DE fractals) may choose a
    # smaller budget suited to its distance estimator.
    step_budget: int | None = None


class SceneBuilder:
    def __init__(self):
        self._instances: List[InstanceSpec] = []
        self._meshes: List = []
        self.camera: Camera = builtin.default_camera()
        self.light_position = builtin.LIGHT_POSITION
        self.light_ambient = builtin.LIGHT_AMBIENT
        self.light_diffuse = builtin.LIGHT_DIFFUSE
        self.plane_material: Optional[Material] = Material(
            (0.9, 0.9, 0.9, 1.0), 0.25, 1.0, 0.4, 50.0, 1.0
        )
        self.plane_origin = builtin.PLANE_ORIGIN
        self.plane_size = builtin.PLANE_SIZE
        self.blas_offset = builtin.BLAS_OFFSET

    def add_instance(self, spec: InstanceSpec) -> "SceneBuilder":
        self._instances.append(spec)
        return self

    def add_mesh_instance(
        self,
        positions,
        indices,
        material: Material,
        *,
        normals=None,
        aabb_min: Tuple[float, float, float],
        aabb_max: Tuple[float, float, float],
        scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
        rotates: bool = False,
        rotation_rate: float = builtin.ROTATION_RATE,
    ) -> "SceneBuilder":
        """Add an indexed-triangle-mesh instance (the triangle BLAS analog,
        Renderer.cpp:575-592). Vertices live in the instance's local space,
        like the procedural primitives; the mesh slot index becomes the
        instance's prim_type."""
        from gpuraytracer.geometry import trimesh

        mesh = trimesh.from_indexed(positions, indices, normals)
        slot = len(self._meshes)
        self._meshes.append(mesh)
        self._instances.append(
            InstanceSpec(
                kind=IntersectorKind.TRIANGLE,
                prim_type=slot,
                aabb_min=aabb_min,
                aabb_max=aabb_max,
                material=material,
                scale=scale,
                rotates=rotates,
                rotation_rate=rotation_rate,
            )
        )
        return self

    def without_plane(self) -> "SceneBuilder":
        self.plane_material = None
        return self

    @property
    def layout(self) -> SceneLayout:
        from gpuraytracer.accel import bvh

        clusters = None
        march = sum(
            1 for s in self._instances
            if s.kind in (IntersectorKind.SIGNED_DISTANCE,
                          IntersectorKind.VOLUMETRIC)
        )
        if bvh.should_cluster(len(self._instances), march_kinds=march):
            # Two-level bounds hierarchy over the static instance AABBs —
            # the BLAS-build analog, host-side, once per scene.
            clusters = bvh.build_clusters(
                np.asarray([s.aabb_min for s in self._instances]),
                np.asarray([s.aabb_max for s in self._instances]),
                leaf_size=bvh.leaf_size_for(len(self._instances)),
            )
        budgets = None
        if any(s.step_budget is not None for s in self._instances):
            from gpuraytracer.core.types import SDF_MAX_STEPS

            budgets = tuple(
                SDF_MAX_STEPS if s.step_budget is None else int(s.step_budget)
                for s in self._instances
            )
        order = None
        if len(self._instances) > 1:
            # Near-to-camera-first processing order (SceneLayout
            # .traversal_order): tile kernels shrink best_t on near
            # geometry before far gates run. Eye in BLAS space: the
            # instance AABBs live there (ray_to_blas subtracts the
            # translation, Renderer.cpp:778-781).
            eye = (np.asarray(self.camera.eye, dtype=np.float64)
                   - np.asarray(self.blas_offset, dtype=np.float64))
            centers = np.asarray(
                [(np.asarray(s.aabb_min, dtype=np.float64)
                  + np.asarray(s.aabb_max, dtype=np.float64)) * 0.5
                 for s in self._instances]
            )
            d2 = ((centers - eye) ** 2).sum(axis=1)
            # Closed-form analytic tests first (near-free, bound t for
            # every march), then marches near-to-far.
            order = tuple(sorted(
                range(len(self._instances)),
                key=lambda i: (
                    self._instances[i].kind != IntersectorKind.ANALYTIC,
                    float(d2[i]),
                ),
            ))
        return SceneLayout(
            kinds=tuple(s.kind for s in self._instances),
            prim_types=tuple(int(s.prim_type) for s in self._instances),
            has_plane=self.plane_material is not None,
            clusters=clusters,
            step_budgets=budgets,
            traversal_order=order,
            material_ids=self._material_mapping()[1],
        )

    def _material_mapping(self):
        """Dedup identical SHADING materials: (unique_mats, material_ids)
        with material_ids mapping each geometry row (instances then plane)
        to its unique slot. The reference's shader table points many
        records at shared root constants the same way
        (Renderer.cpp:201-250: ~11 materials reused across instances);
        deduping keeps the kernels' material select chains short and the
        fused-kernel 16-material cap a cap on UNIQUE materials.
        step_scale is a per-geometry march parameter, keyed out."""
        mats = [s.material for s in self._instances]
        if self.plane_material is not None:
            mats = mats + [self.plane_material]
        uniq, ids, index = [], [], {}
        for m in mats:
            key = (tuple(m.albedo), float(m.reflectance), float(m.diffuse),
                   float(m.specular), float(m.specular_power))
            slot = index.get(key)
            if slot is None:
                slot = len(uniq)
                index[key] = slot
                uniq.append(m)
            ids.append(slot)
        return uniq, tuple(ids)

    def _material_table(self) -> MaterialTable:
        mats = [s.material for s in self._instances]
        if self.plane_material is not None:
            mats = mats + [self.plane_material]
        uniq, _ = self._material_mapping()
        return MaterialTable(
            albedo=jnp.asarray([m.albedo for m in uniq], dtype=jnp.float32),
            reflectance_coefficient=jnp.asarray([m.reflectance for m in uniq], dtype=jnp.float32),
            diffuse_coefficient=jnp.asarray([m.diffuse for m in uniq], dtype=jnp.float32),
            specular_coefficient=jnp.asarray([m.specular for m in uniq], dtype=jnp.float32),
            specular_power=jnp.asarray([m.specular_power for m in uniq], dtype=jnp.float32),
            # Per-GEOMETRY (not deduped): marchers index step_scale by
            # instance id (accel/traverse).
            step_scale=jnp.asarray([m.step_scale for m in mats], dtype=jnp.float32),
        )

    def _transforms(self, elapsed_time) -> InstanceTransforms:
        t = jnp.asarray(elapsed_time, dtype=jnp.float32)
        eye3 = jnp.eye(3, dtype=jnp.float32)
        l2b_rows, b2l_rows = [], []
        for s in self._instances:
            if s.rotates:
                theta = s.rotation_rate * t
                c, sn = jnp.cos(theta), jnp.sin(theta)
                rot = jnp.stack(
                    [
                        jnp.stack([c, jnp.zeros_like(c), sn]),
                        jnp.asarray([0.0, 1.0, 0.0], dtype=jnp.float32),
                        jnp.stack([-sn, jnp.zeros_like(c), c]),
                    ]
                )
                rot_inv = rot.T
            else:
                rot = eye3
                rot_inv = eye3
            scale = jnp.asarray(s.scale, dtype=jnp.float32)
            a = rot * scale
            a_inv = rot_inv / scale[:, None]
            center = (
                jnp.asarray(s.aabb_min, dtype=jnp.float32)
                + jnp.asarray(s.aabb_max, dtype=jnp.float32)
            ) * 0.5
            l2b = jnp.zeros((4, 4), dtype=jnp.float32)
            l2b = l2b.at[:3, :3].set(a).at[:3, 3].set(center).at[3, 3].set(1.0)
            # Explicit matvec keeps f32 off TF32 (see models/builtin.py).
            tcol = -(a_inv[:, 0] * center[0] + a_inv[:, 1] * center[1]
                     + a_inv[:, 2] * center[2])
            b2l = jnp.zeros((4, 4), dtype=jnp.float32)
            b2l = b2l.at[:3, :3].set(a_inv).at[:3, 3].set(tcol).at[3, 3].set(1.0)
            l2b_rows.append(l2b)
            b2l_rows.append(b2l)
        return InstanceTransforms(
            local_to_blas=jnp.stack(l2b_rows), blas_to_local=jnp.stack(b2l_rows)
        )

    def animator(self):
        """Returns a jittable fn(arrays, elapsed_time) -> arrays that
        advances the per-frame transforms and elapsed_time — the
        builtin.animate_arrays equivalent for builder scenes, so frame
        loops dispatch one program per frame instead of rebuilding the
        scene host-side."""
        import dataclasses as _dc

        def animate(arrays: SceneArrays, elapsed_time) -> SceneArrays:
            t = jnp.asarray(elapsed_time, dtype=jnp.float32)
            constants = _dc.replace(arrays.constants, elapsed_time=t)
            return _dc.replace(
                arrays, constants=constants, transforms=self._transforms(t)
            )

        return animate

    def build(self, aspect: float, elapsed_time=0.0) -> Scene:
        if not self._instances:
            raise ValueError("scene has no instances")
        constants = make_scene_constants(
            projection_to_world=self.camera.projection_to_world(aspect).astype(np.float32),
            camera_position=tuple(self.camera.eye) + (1.0,),
            light_position=self.light_position,
            light_ambient_color=self.light_ambient,
            light_diffuse_color=self.light_diffuse,
            elapsed_time=elapsed_time,
        )
        arrays = SceneArrays(
            constants=constants,
            materials=self._material_table(),
            transforms=self._transforms(elapsed_time),
            aabb_min=jnp.asarray([s.aabb_min for s in self._instances], dtype=jnp.float32),
            aabb_max=jnp.asarray([s.aabb_max for s in self._instances], dtype=jnp.float32),
            blas_offset=jnp.asarray(self.blas_offset, dtype=jnp.float32),
            plane_origin=jnp.asarray(self.plane_origin, dtype=jnp.float32),
            plane_size=jnp.asarray(self.plane_size, dtype=jnp.float32),
            meshes=tuple(self._meshes),
        )
        return Scene(layout=self.layout, arrays=arrays)


def grid_cell_aabb(ix: int, iz: int, size=(2.0, 2.0, 2.0), grid=(4, 1, 4)):
    """AABB placement on the reference's 4x1x4 grid (Renderer.cpp:490-504)."""
    base = tuple(
        -(n * builtin.AABB_WIDTH + (n - 1) * builtin.AABB_DISTANCE) / 2.0 for n in grid
    )
    stride = builtin.AABB_WIDTH + builtin.AABB_DISTANCE
    mn = (base[0] + ix * stride, base[1], base[2] + iz * stride)
    mx = tuple(mn[k] + size[k] for k in range(3))
    return mn, mx
