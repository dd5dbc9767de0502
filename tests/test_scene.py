"""Built-in scene data tests — every constant from Renderer.cpp."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.core.types import CHROMIUM_REFLECTANCE, TOTAL_PRIMITIVE_COUNT
from gpuraytracer.models import builtin


def test_grid_base_position():
    # base = -(4*2 + 3*2)/2 = -7 in x/z; -(1*2)/2 = -1 in y.
    assert builtin._BASE == (-7.0, -1.0, -7.0)


def test_aabb_table_matches_reference_placement():
    expected_min = np.array(
        [
            [5, -1, -7],  # AnalyticPrimitive::AABB       idx (3,0,0) size (2,3,2)
            [2, -1, -4],  # Spheres                        idx (2.25,0,0.75) size 3
            [-7, -1, -7],  # Metaballs                     idx (0,0,0) size 3
            [1, -1, -7],  # MiniSpheres                    idx (2,0,0) size 2
            [-7, -1, 1],  # IntersectedRoundCube           idx (0,0,2) size 2
            [-4, -1.4, 2],  # SquareTorus                  idx (0.75,-0.1,2.25) size 3
            [-7, -1, -3],  # TwistedTorus                  idx (0,0,1) size 2
            [-3, -1, -7],  # Cog                           idx (1,0,0) size 2
            [-7, -1, 5],  # Cylinder                       idx (0,0,3) size (2,3,2)
            [1, -1, 1],  # FractalPyramid                  idx (2,0,2) size 6
        ],
        dtype=np.float32,
    )
    expected_size = np.array(
        [
            [2, 3, 2], [3, 3, 3], [3, 3, 3], [2, 2, 2], [2, 2, 2],
            [3, 3, 3], [2, 2, 2], [2, 2, 2], [2, 3, 2], [6, 6, 6],
        ],
        dtype=np.float32,
    )
    np.testing.assert_allclose(builtin.AABB_MIN, expected_min, atol=1e-6)
    np.testing.assert_allclose(
        builtin.AABB_MAX - builtin.AABB_MIN, expected_size, atol=1e-6
    )


def test_material_table():
    mats = builtin.material_table()
    assert mats.albedo.shape == (TOTAL_PRIMITIVE_COUNT + 1, 4)
    # Chromium mirrors: spheres (1), metaballs (2), square torus (5).
    for i in (1, 2, 5):
        np.testing.assert_allclose(np.asarray(mats.albedo[i]), CHROMIUM_REFLECTANCE)
        assert float(mats.reflectance_coefficient[i]) == 1.0
    # Plane: last row.
    np.testing.assert_allclose(np.asarray(mats.albedo[-1]), [0.9, 0.9, 0.9, 1.0])
    assert float(mats.reflectance_coefficient[-1]) == pytest.approx(0.25)
    assert float(mats.diffuse_coefficient[-1]) == 1.0
    assert float(mats.specular_coefficient[-1]) == pytest.approx(0.4)
    # Step scales: twisted torus 0.5, fractal pyramid 0.8, others 1.
    assert float(mats.step_scale[6]) == pytest.approx(0.5)
    assert float(mats.step_scale[9]) == pytest.approx(0.8)
    assert float(mats.step_scale[0]) == 1.0
    # Cog: yellow, specular 0.1, power 2.
    assert float(mats.specular_power[7]) == 2.0


def test_plane_instance_extents():
    # 700 cells of width 2 with 699 gaps of 2 -> 2798; offset -0.35*width.
    assert builtin.PLANE_WIDTH[0] == pytest.approx(2798.0)
    assert builtin.PLANE_ORIGIN[0] == pytest.approx(-979.3)
    assert builtin.PLANE_SIZE == (pytest.approx(2798.0), pytest.approx(2798.0))


def test_transforms_roundtrip_and_centers():
    tf = builtin.build_instance_transforms(jnp.float32(1.23))
    l2b = np.asarray(tf.local_to_blas)
    b2l = np.asarray(tf.blas_to_local)
    for i in range(TOTAL_PRIMITIVE_COUNT):
        np.testing.assert_allclose(l2b[i] @ b2l[i], np.eye(4), atol=1e-5)
        # Local origin maps to the AABB center.
        center = (builtin.AABB_MIN[i] + builtin.AABB_MAX[i]) / 2.0
        np.testing.assert_allclose(l2b[i][:3, 3], center, atol=1e-6)


def test_rotation_animates_only_marked_instances():
    t0 = builtin.build_instance_transforms(jnp.float32(0.0))
    t1 = builtin.build_instance_transforms(jnp.float32(0.5))
    a0 = np.asarray(t0.local_to_blas)
    a1 = np.asarray(t1.local_to_blas)
    rotating = [i for i, (_, r) in enumerate(builtin.TRANSFORM_SPECS) if r]
    static = [i for i, (_, r) in enumerate(builtin.TRANSFORM_SPECS) if not r]
    assert rotating == [1, 2, 6, 7]
    for i in rotating:
        assert not np.allclose(a0[i], a1[i])
    for i in static:
        np.testing.assert_allclose(a0[i], a1[i], atol=1e-7)


def test_rotation_direction_matches_reference():
    # XMMatrixRotationY(-2t) row-convention: at t small, a local +x point
    # moves toward -z in BLAS space (x' = x cos, z' = -x sin(theta),
    # theta = -2t -> z' = +x sin(2t) ... verify against the exact formula).
    t = 0.1
    tf = builtin.build_instance_transforms(jnp.float32(t))
    # Spheres instance (index 1), scale 1.5, rotating.
    m = np.asarray(tf.local_to_blas[1])
    p_local = np.array([1.0, 0.0, 0.0, 1.0])
    p_blas = m @ p_local
    theta = -2.0 * t
    c, s = np.cos(theta), np.sin(theta)
    center = (builtin.AABB_MIN[1] + builtin.AABB_MAX[1]) / 2.0
    # Row-vector math: x' = 1.5*(x c + z s), z' = 1.5*(-x s + z c), + center
    expected = center + 1.5 * np.array([c, 0.0, -s])
    np.testing.assert_allclose(p_blas[:3], expected, atol=1e-5)


def test_scene_constants(builtin_scene):
    c = builtin_scene.arrays.constants
    np.testing.assert_allclose(np.asarray(c.light_position), [0, 18, -20, 0])
    np.testing.assert_allclose(np.asarray(c.light_ambient_color), [0.25] * 3 + [1.0])
    np.testing.assert_allclose(np.asarray(c.light_diffuse_color), [0.6] * 3 + [1.0])
    cam = np.asarray(c.camera_position)
    s = 17.0 * np.sin(np.radians(45.0))
    np.testing.assert_allclose(cam, [-s, 5.3, -s, 1.0], atol=1e-5)


def test_layout():
    assert builtin.LAYOUT.num_procedural == TOTAL_PRIMITIVE_COUNT == 10
    assert builtin.LAYOUT.plane_geometry_id == 10
    assert builtin.LAYOUT.num_geometries == 11
