"""Metaball field + march unit tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.geometry import metaballs

TMAX = 10000.0


def _p(*xyz):
    return jnp.asarray([xyz], dtype=jnp.float32)


@functools.partial(jax.jit, static_argnames=("t_max", "cull_backface"))
def _march(o, d, elapsed, t_max=TMAX, cull_backface=True):
    return metaballs.intersect_metaballs(
        o, d, elapsed, t_max=t_max, cull_backface=cull_backface
    )


def test_potential_at_center_is_one():
    # The reference's quintic uses d = radius - dist, so f(center) = 1
    # (f(0)=0, f(radius)=1 noted in hlsli:44-49).
    c = jnp.asarray([0.0, 0.0, 0.0], dtype=jnp.float32)
    v = float(metaballs.metaball_potential(_p(0, 0, 0), c, 0.5)[0])
    assert v == pytest.approx(1.0)


def test_potential_zero_outside_radius():
    c = jnp.asarray([0.0, 0.0, 0.0], dtype=jnp.float32)
    v = float(metaballs.metaball_potential(_p(0.6, 0, 0), c, 0.5)[0])
    assert v == 0.0


def test_potential_half_radius():
    # d/r = 0.5 -> 6/32 - 15/16 + 10/8 = 0.5 (smoothstep-like quintic).
    c = jnp.asarray([0.0, 0.0, 0.0], dtype=jnp.float32)
    v = float(metaballs.metaball_potential(_p(0.25, 0, 0), c, 0.5)[0])
    assert v == pytest.approx(0.5, abs=1e-6)


def test_animated_centers_at_keyframes():
    c0, _ = metaballs.animated_metaballs(jnp.float32(0.0))
    np.testing.assert_allclose(
        np.asarray(c0), [k[0] for k in metaballs.KEYFRAME_CENTERS], atol=1e-6
    )
    c1, _ = metaballs.animated_metaballs(jnp.float32(6.0))  # half cycle -> t=1
    np.testing.assert_allclose(
        np.asarray(c1), [k[1] for k in metaballs.KEYFRAME_CENTERS], atol=1e-6
    )


def test_march_hits_a_ball():
    # At t=0 ball 1 center is (0, -0.2, 0.5), radius 0.55. Shoot straight at it.
    o = jnp.asarray([(0.0, -0.2, -5.0)], dtype=jnp.float32)
    d = jnp.asarray([(0.0, 0.0, 1.0)], dtype=jnp.float32)
    hit, t, n = _march(o, d, jnp.float32(0.0))
    assert bool(hit[0])
    # Isosurface lies inside the bounding sphere: entry at 5.5 - 0.55 = 4.95.
    assert 4.9 < float(t[0]) < 5.6
    # Normal faces back toward the ray.
    assert float(n[0, 2]) < 0.0


def test_march_miss():
    o = jnp.asarray([(0.0, 5.0, -5.0)], dtype=jnp.float32)
    d = jnp.asarray([(0.0, 0.0, 1.0)], dtype=jnp.float32)
    hit, t, _ = _march(o, d, jnp.float32(0.0))
    assert not bool(hit[0])
    assert np.isinf(float(t[0]))


def test_bounding_interval_union():
    centers, radii = metaballs.animated_metaballs(jnp.float32(0.0))
    o = jnp.asarray([(0.0, 0.0, -5.0)], dtype=jnp.float32)
    d = jnp.asarray([(0.0, 0.0, 1.0)], dtype=jnp.float32)
    tmin, tmax = metaballs.find_intersecting_metaballs(
        o, d, centers, radii, 0.0, TMAX
    )
    assert float(tmin[0]) > 0.0 and float(tmax[0]) > float(tmin[0])
    # Interval must cover every intersected bounding sphere.
    assert float(tmax[0]) - float(tmin[0]) < 3.0
