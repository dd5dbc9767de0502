"""Generic indexed-triangle-mesh geometry (geometry/trimesh.py).

The reference's triangle BLAS path is general (vertex/index buffers,
u16 indices — Renderer.cpp:575-592, RaytracingShaderHelper.hlsli:56-86);
these tests prove this equivalent is too: the ground quad re-expressed
as a 2-triangle mesh matches the rect fast path exactly, closed-form
single-triangle hits land where Möller–Trumbore says they must, the
lax.scan (many-face) path agrees with the unrolled path, and a non-rect
mesh renders correctly inside a full scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.accel import traverse
from gpuraytracer.geometry import trimesh
from gpuraytracer.models.builder import Material, SceneBuilder


def _rand_rays(n, seed, span=30.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, size=(n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 25.0, size=n)  # above the plane
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


# ---------------------------------------------------------------------------
# Ground quad as a mesh == the rect fast path (VERDICT: "re-express the
# ground plane through it")
# ---------------------------------------------------------------------------

def test_ground_quad_mesh_matches_plane_fast_path():
    origin = (-979.3, 0.0, -979.3)
    size = (2798.0, 2798.0)
    mesh = trimesh.ground_quad_mesh(
        origin=(origin[0], origin[1], origin[2]), size=size
    )
    o, d = _rand_rays(4096, seed=0)

    hit_m, t_m, n_m = trimesh.intersect_trimesh(
        o, d, mesh, t_min=0.0, t_max=10000.0, cull_backface=True
    )
    hit_p, t_p = traverse.intersect_plane(
        o, d, jnp.asarray(origin), jnp.asarray(size), t_min=0.0, t_max=10000.0
    )

    # The two triangles tile the rect exactly; only rays passing within an
    # ulp of the shared diagonal may differ. Allow no mismatches at all —
    # random rays never land on the diagonal exactly.
    assert bool(jnp.all(hit_m == hit_p))
    both = np.asarray(hit_m & hit_p)
    np.testing.assert_allclose(
        np.asarray(t_m)[both], np.asarray(t_p)[both], rtol=1e-5, atol=1e-3
    )
    # Flat +Y normal everywhere it hits.
    nm = np.asarray(n_m)[both]
    np.testing.assert_allclose(nm, np.tile([0.0, 1.0, 0.0], (nm.shape[0], 1)), atol=1e-6)


def test_backface_cull_from_below():
    mesh = trimesh.ground_quad_mesh(origin=(-1, 0, -1), size=(2, 2))
    o = jnp.asarray([[0.0, -5.0, 0.0]], dtype=jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]], dtype=jnp.float32)
    hit, _, _ = trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=100.0)
    assert not bool(hit[0])
    hit_nc, t_nc, _ = trimesh.intersect_trimesh(
        o, d, mesh, t_min=0.0, t_max=100.0, cull_backface=False
    )
    assert bool(hit_nc[0]) and abs(float(t_nc[0]) - 5.0) < 1e-5


# ---------------------------------------------------------------------------
# Closed-form single-triangle hits
# ---------------------------------------------------------------------------

def test_single_triangle_closed_form():
    # Right triangle in the z=2 plane, CCW seen from -z (normal -z).
    positions = [(0, 0, 2), (1, 0, 2), (0, 1, 2)]
    indices = [[0, 2, 1]]  # wind so the geometric normal faces -z
    mesh = trimesh.from_indexed(positions, indices)
    np.testing.assert_allclose(np.asarray(mesh.n[0]), [0, 0, -1], atol=1e-6)

    o = jnp.asarray([[0.25, 0.25, 0.0]], dtype=jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32)
    hit, t, n = trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=10.0)
    assert bool(hit[0])
    assert abs(float(t[0]) - 2.0) < 1e-6
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-6)

    # Outside the triangle (u+v > 1): miss.
    o2 = jnp.asarray([[0.9, 0.9, 0.0]], dtype=jnp.float32)
    hit2, _, _ = trimesh.intersect_trimesh(o2, d, mesh, t_min=0.0, t_max=10.0)
    assert not bool(hit2[0])

    # t-range: hit beyond t_max rejected.
    hit3, _, _ = trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=1.5)
    assert not bool(hit3[0])


def test_vertex0_normal_rule():
    """The reference shades with g_vertices[indices[0]].normal
    (Raytracing.hlsl:184-187), NOT the geometric normal."""
    positions = [(0, 0, 2), (1, 0, 2), (0, 1, 2)]
    tilted = np.asarray([[0.0, 0.6, -0.8]] * 3, dtype=np.float32)
    mesh = trimesh.from_indexed(positions, [[0, 2, 1]], normals=tilted)
    o = jnp.asarray([[0.25, 0.25, 0.0]], dtype=jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32)
    hit, _, n = trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=10.0)
    assert bool(hit[0])
    np.testing.assert_allclose(np.asarray(n[0]), [0.0, 0.6, -0.8], atol=1e-6)


# ---------------------------------------------------------------------------
# Scan path (> _UNROLL_FACES) == unrolled path
# ---------------------------------------------------------------------------

def _octahedron(radius=1.0):
    r = radius
    positions = [
        (r, 0, 0), (-r, 0, 0), (0, r, 0), (0, -r, 0), (0, 0, r), (0, 0, -r)
    ]
    # CCW-outward faces.
    indices = [
        [0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
        [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5],
    ]
    return positions, indices


def test_scan_path_matches_unrolled():
    positions, indices = _octahedron()
    # 16 faces (> _UNROLL_FACES): two octahedra, one shrunk inside.
    pos2 = [tuple(0.5 * c for c in p) for p in positions]
    all_pos = positions + pos2
    all_idx = indices + [[i + 6 for i in f] for f in indices]
    mesh_big = trimesh.from_indexed(all_pos, all_idx)
    assert mesh_big.num_faces == 16

    o, d = _rand_rays(2048, seed=3, span=3.0)
    hit_s, t_s, n_s = trimesh.intersect_trimesh(
        o, d, mesh_big, t_min=0.0, t_max=100.0
    )

    # Brute force with the unrolled path, face by face.
    best_t = jnp.full(o.shape[:-1], jnp.inf)
    best_n = jnp.zeros_like(o)
    found = jnp.zeros(o.shape[:-1], dtype=bool)
    for f in range(16):
        sub = trimesh.TriangleMesh(
            v0=mesh_big.v0[f : f + 1], e1=mesh_big.e1[f : f + 1],
            e2=mesh_big.e2[f : f + 1], n=mesh_big.n[f : f + 1],
        )
        h, t, n = trimesh.intersect_trimesh(o, d, sub, t_min=0.0, t_max=100.0)
        closer = h & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_n = jnp.where(closer[..., None], n, best_n)
        found = found | closer

    assert bool(jnp.all(hit_s == found))
    m = np.asarray(found)
    np.testing.assert_allclose(np.asarray(t_s)[m], np.asarray(best_t)[m], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(n_s)[m], np.asarray(best_n)[m], atol=1e-6)


# ---------------------------------------------------------------------------
# A non-rect mesh inside a full scene (VERDICT done-criterion)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_scene():
    b = SceneBuilder()
    positions, indices = _octahedron()
    b.add_mesh_instance(
        positions, indices, Material((1.0, 0.2, 0.2, 1.0)),
        aabb_min=(-1.5, -1.5, -1.5), aabb_max=(1.5, 1.5, 1.5),
        scale=(1.0, 1.0, 1.0),
    )
    return b.build(aspect=1.0, elapsed_time=0.0)


def test_mesh_instance_closest_hit(mesh_scene):
    scene = mesh_scene
    # The instance AABB centers at the origin of BLAS space; BLAS offset is
    # builtin's (0, 1, 0), so the octahedron centers at world (0, 1, 0).
    # A +z world ray offset from the vertices (vertex-exact hits are
    # Möller-Trumbore boundary cases): local (0.2, 0.1, z).
    o = jnp.asarray([[0.2, 1.1, -10.0]], dtype=jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32)
    hit = traverse.closest_hit(o, d, scene)
    assert bool(hit.hit[0])
    assert int(hit.geometry_id[0]) == 0
    # Octahedron |x|+|y|+|z| = 1 surface: entry at z = -(1-0.2-0.1) = -0.7
    # -> t = 9.3.
    assert abs(float(hit.t[0]) - 9.3) < 1e-4
    n = np.asarray(hit.normal[0])
    assert abs(np.linalg.norm(n) - 1.0) < 1e-5
    assert n[2] < -0.5  # faces back toward the ray


def test_mesh_instance_renders(mesh_scene):
    from gpuraytracer.render import trace

    img = trace.render_frame(mesh_scene, 64, 64)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    # The mesh must be visible from the builtin camera: some pixels shade
    # with its red albedo (distinct from plane gray / background blue).
    center = img[24:40, 24:40, :3]
    assert img[:, :, :3].max() <= 1.5
    # Red-dominant pixels exist somewhere in the frame.
    red_dom = (img[..., 0] > img[..., 1] + 0.1) & (img[..., 0] > img[..., 2] + 0.1)
    assert red_dom.any()


def test_mesh_occludes_shadow(mesh_scene):
    scene = mesh_scene
    # Point under the octahedron (offset off the bottom vertex), shadow ray
    # straight up: the mesh occludes. The up-ray is back-facing to the
    # ground plane, so only the mesh can occlude here.
    o = jnp.asarray([[0.1, -0.49, 0.0]], dtype=jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]], dtype=jnp.float32)
    occ = traverse.any_hit(o, d, scene)
    assert bool(occ[0])
