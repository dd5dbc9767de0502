"""Analytic intersector unit tests against closed-form expectations."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.geometry import analytic

TMAX = 10000.0


def _ray(o, d):
    return (
        jnp.asarray([o], dtype=jnp.float32),
        jnp.asarray([d], dtype=jnp.float32),
    )


class TestHollowSphere:
    def test_head_on_hit(self):
        o, d = _ray((0, 0, -5), (0, 0, 1))
        hit, t, n = analytic.intersect_hollow_sphere(
            o, d, (0, 0, 0), 1.0, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert bool(hit[0])
        assert float(t[0]) == pytest.approx(4.0, abs=1e-5)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-5)

    def test_miss(self):
        o, d = _ray((0, 3, -5), (0, 0, 1))
        hit, t, _ = analytic.intersect_hollow_sphere(
            o, d, (0, 0, 0), 1.0, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert not bool(hit[0])
        assert np.isinf(float(t[0]))

    def test_inside_sphere_backface_culled(self):
        # From the center, both crossings are exits (normal along ray) —
        # back-face culling rejects them.
        o, d = _ray((0, 0, 0), (0, 0, 1))
        hit, _, _ = analytic.intersect_hollow_sphere(
            o, d, (0, 0, 0), 1.0, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert not bool(hit[0])

    def test_inside_sphere_no_cull_hits_far_side(self):
        o, d = _ray((0, 0, 0), (0, 0, 1))
        hit, t, _ = analytic.intersect_hollow_sphere(
            o, d, (0, 0, 0), 1.0, t_min=0.0, t_max=TMAX, cull_backface=False
        )
        assert bool(hit[0])
        assert float(t[0]) == pytest.approx(1.0, abs=1e-6)

    def test_grazing_tangent(self):
        # Tangent ray: discriminant ~ 0, single touch point at t = 5.
        o, d = _ray((1.0, 0, -5), (0, 0, 1))
        hit, t, _ = analytic.intersect_hollow_sphere(
            o, d, (0, 0, 0), 1.0, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        if bool(hit[0]):  # f32 roundoff may call it a miss; both are legal
            assert float(t[0]) == pytest.approx(5.0, abs=1e-2)


class TestThreeSpheres:
    def test_closest_of_three(self):
        # Ray along -z..+z through x=y=-0.3 region: big sphere (r=0.6 at
        # (-0.3,-0.3,-0.3)) should be hit first from z=-5.
        o, d = _ray((-0.3, -0.3, -5.0), (0, 0, 1))
        hit, t, n = analytic.intersect_spheres(
            o, d, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert bool(hit[0])
        assert float(t[0]) == pytest.approx(5.0 - 0.3 - 0.6, abs=1e-5)

    def test_small_sphere_from_positive_z(self):
        o, d = _ray((0.35, 0.35, 5.0), (0, 0, -1))
        hit, t, _ = analytic.intersect_spheres(
            o, d, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert bool(hit[0])
        # sphere 3: center (0.35,0.35,0), r=0.15 -> first hit at z=0.15
        assert float(t[0]) == pytest.approx(5.0 - 0.15, abs=1e-5)


class TestAABB:
    def test_interval(self):
        o, d = _ray((0, 0, -5), (0, 0, 1))
        tmin, tmax = analytic.aabb_interval(o, d, (-1, -1, -1), (1, 1, 1))
        assert float(tmin[0]) == pytest.approx(4.0)
        assert float(tmax[0]) == pytest.approx(6.0)

    def test_axis_parallel_inside_slab(self):
        # Ray parallel to x slabs, within them: inf handling must not poison.
        o, d = _ray((0.0, 0.0, -5), (0, 0, 1))
        m = analytic.aabb_hit_mask(o, d, (-1, -1, -1), (1, 1, 1), t_min=0.0, t_max=TMAX)
        assert bool(m[0])

    def test_axis_parallel_outside_slab(self):
        o, d = _ray((2.0, 0.0, -5), (0, 0, 1))
        m = analytic.aabb_hit_mask(o, d, (-1, -1, -1), (1, 1, 1), t_min=0.0, t_max=TMAX)
        assert not bool(m[0])

    def test_hollow_aabb_face_normal(self):
        o, d = _ray((0.2, 0.3, -5), (0, 0, 1))
        hit, t, n = analytic.intersect_hollow_aabb(
            o, d, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert bool(hit[0])
        assert float(t[0]) == pytest.approx(4.0, abs=1e-4)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-6)

    def test_hollow_aabb_from_inside_rejected(self):
        # Entry crossing is behind the origin -> tmin < t_min -> no hit
        # (reference only accepts outside-in crossings).
        o, d = _ray((0, 0, 0), (0, 0, 1))
        hit, _, _ = analytic.intersect_hollow_aabb(
            o, d, t_min=0.0, t_max=TMAX, cull_backface=True
        )
        assert not bool(hit[0])

    def test_diagonal_hit_each_face(self):
        for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
            origin = [0.0, 0.0, 0.0]
            origin[axis] = 5.0 * sign
            direction = [0.0, 0.0, 0.0]
            direction[axis] = -1.0 * sign
            o, d = _ray(tuple(origin), tuple(direction))
            hit, t, n = analytic.intersect_hollow_aabb(
                o, d, t_min=0.0, t_max=TMAX, cull_backface=True
            )
            assert bool(hit[0])
            expected_n = [0.0, 0.0, 0.0]
            expected_n[axis] = float(sign)
            np.testing.assert_allclose(np.asarray(n[0]), expected_n, atol=1e-6)
