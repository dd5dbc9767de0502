"""Generic indexed-triangle-mesh geometry — the triangle BLAS path.

The reference ingests arbitrary vertex/index buffers into a triangle BLAS
(Renderer.cpp:575-592: 6 u16 indices + 4 {position, normal} vertices for
the ground quad; u16 index loading via the dword-alignment trick in
RaytracingShaderHelper.hlsli:56-86) and shades triangle hits with the
FLAT normal of the triangle's first vertex
(Raytracing.hlsl:171-218: ``g_vertices[indices[0]].normal``).

Form here: the index load happens once at build time on the host — faces
are flattened into a struct-of-arrays of (v0, e1, e2, n) rows so the
intersector is pure dense vector math with no per-ray gathers.
Intersection is Möller–Trumbore, vectorized over
the ray wavefront, with a ``lax.scan`` over faces (static unroll for tiny
meshes); back-face culling follows the DXR winding rule the plane relies
on (RAY_FLAG_CULL_BACK_FACING_TRIANGLES, Raytracing.hlsl:107).

Meshes live in the instance's local space — the same space the procedural
primitives intersect in — so instance transforms, AABB gating, and normal
transforms come from the shared accel machinery unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from gpuraytracer.core import hlsl

# Faces below this count unroll statically instead of lax.scan — the scan
# carry setup costs more than the unrolled body for a handful of faces.
_UNROLL_FACES = 8

_DET_EPS = 1e-12


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Face struct-of-arrays: one row per triangle.

    n is the shading normal reported on hit — the first vertex's normal
    when vertex normals are supplied (the reference's flat-normal rule,
    Raytracing.hlsl:184-187), else the geometric (winding) normal.
    """

    v0: Any  # (F, 3) first vertex
    e1: Any  # (F, 3) v1 - v0
    e2: Any  # (F, 3) v2 - v0
    n: Any  # (F, 3) unit shading normal

    @property
    def num_faces(self) -> int:
        return self.v0.shape[0]

    def tree_flatten(self):
        return (self.v0, self.e1, self.e2, self.n), None

    @classmethod
    def tree_unflatten(cls, _, children):
        return cls(*children)


def from_indexed(positions, indices, normals=None) -> TriangleMesh:
    """Build a mesh from vertex/index buffers (the BLAS-build analog,
    Renderer.cpp:575-592). indices: (F, 3) integer (u16 or u32 — the
    reference's 16-bit index format widens losslessly); positions /
    normals: (V, 3). The index gather runs once here, host-side."""
    positions = np.asarray(positions, dtype=np.float32)
    indices = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    if normals is not None:
        n = np.asarray(normals, dtype=np.float32)[indices[:, 0]]
    else:
        n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    j = jnp.asarray
    return TriangleMesh(v0=j(p0), e1=j(e1), e2=j(e2), n=j(n))


def ground_quad_mesh(origin=(0.0, 0.0, 0.0), size=(1.0, 1.0)) -> TriangleMesh:
    """The reference's ground quad as an indexed mesh: 4 vertices with +Y
    normals, 6 u16 indices (Renderer.cpp:539-565). Winding chosen so the
    up-face is front-facing (rays from above survive the back-face cull),
    matching accel/traverse.intersect_plane."""
    ox, oy, oz = origin
    sx, sz = size
    positions = [
        (ox, oy, oz),
        (ox, oy, oz + sz),
        (ox + sx, oy, oz + sz),
        (ox + sx, oy, oz),
    ]
    normals = [(0.0, 1.0, 0.0)] * 4
    indices = np.asarray([[0, 1, 2], [0, 2, 3]], dtype=np.uint16)
    return from_indexed(positions, indices, normals)


def _mt_face(origins, directions, v0, e1, e2, n, t_min, t_max, cull_backface):
    """Möller–Trumbore for one face against the whole wavefront. Returns
    (hit, t). det = dot(e1, d x e2) = -dot(d, e1 x e2): front-facing
    (ray against the winding normal) iff det > 0, so the DXR back-face
    cull is the det > 0 branch."""
    pv = hlsl.cross(directions, jnp.broadcast_to(e2, directions.shape))
    det = hlsl.dot(jnp.broadcast_to(e1, directions.shape), pv)
    if cull_backface:
        det_ok = det > _DET_EPS
    else:
        det_ok = jnp.abs(det) > _DET_EPS
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    tv = origins - v0
    u = hlsl.dot(tv, pv) * inv_det
    qv = hlsl.cross(tv, jnp.broadcast_to(e1, tv.shape))
    v = hlsl.dot(jnp.broadcast_to(directions, qv.shape), qv) * inv_det
    t = hlsl.dot(jnp.broadcast_to(e2, qv.shape), qv) * inv_det
    hit = (
        det_ok
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return hit, jnp.where(hit, t, jnp.inf)


def intersect_trimesh(
    origins, directions, mesh: TriangleMesh, *, t_min, t_max, cull_backface=True
):
    """Closest hit over all faces. Same contract as the other intersectors:
    local-space rays shaped (..., 3) -> (hit, t, normal) with t = +inf on
    miss; closest-hit-wins across faces (the triangle BLAS traversal
    analog)."""
    batch = origins.shape[:-1]
    f32 = origins.dtype

    if mesh.num_faces <= _UNROLL_FACES:
        best_t = jnp.full(batch, jnp.inf, dtype=f32)
        best_n = jnp.zeros(batch + (3,), dtype=f32)
        found = jnp.zeros(batch, dtype=bool)
        for f in range(mesh.num_faces):
            hit, t = _mt_face(
                origins, directions,
                mesh.v0[f], mesh.e1[f], mesh.e2[f], mesh.n[f],
                t_min, t_max, cull_backface,
            )
            closer = hit & (t < best_t)
            best_t = jnp.where(closer, t, best_t)
            best_n = jnp.where(closer[..., None], mesh.n[f], best_n)
            found = found | closer
        return found, best_t, best_n

    def body(carry, face):
        best_t, best_n, found = carry
        v0, e1, e2, n = face
        hit, t = _mt_face(
            origins, directions, v0, e1, e2, n, t_min, t_max, cull_backface
        )
        closer = hit & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_n = jnp.where(closer[..., None], n, best_n)
        return (best_t, best_n, found | closer), None

    init = (
        jnp.full(batch, jnp.inf, dtype=f32),
        jnp.zeros(batch + (3,), dtype=f32),
        jnp.zeros(batch, dtype=bool),
    )
    (best_t, best_n, found), _ = jax.lax.scan(
        body, init, (mesh.v0, mesh.e1, mesh.e2, mesh.n)
    )
    return found, best_t, best_n
