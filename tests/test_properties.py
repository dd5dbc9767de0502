"""Property tests (SURVEY.md §4): invariants over randomized rays.

- hit normals are unit length and face the ray (back-face culling on)
- hit t lies within [RAY_TMIN, RAY_TMAX]
- a closest hit implies the occlusion query reports a hit for the same ray
- geometry ids index the material table
- misses report t == RAY_TMAX and geometry_id == -1
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.accel import traverse
from gpuraytracer.accel.instances import Scene
from gpuraytracer.core.types import RAY_TMAX, RAY_TMIN
from gpuraytracer.models import builtin

N = 2048


@pytest.fixture(scope="module")
def random_query(rng):
    scene = builtin.build_scene(aspect=1.0, elapsed_time=1.3)
    # Rays from a shell around the scene pointed at random scene points.
    origins = rng.uniform(-14, 14, size=(N, 3))
    origins[:, 1] = rng.uniform(0.5, 12, size=N)
    targets = rng.uniform(-7, 7, size=(N, 3))
    targets[:, 1] = rng.uniform(0.0, 3.0, size=N)
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = jnp.asarray(origins, dtype=jnp.float32)
    d = jnp.asarray(dirs, dtype=jnp.float32)

    hit = jax.jit(lambda o, d, a: traverse.closest_hit(o, d, Scene(scene.layout, a)))(
        o, d, scene.arrays
    )
    occluded = jax.jit(lambda o, d, a: traverse.any_hit(o, d, Scene(scene.layout, a)))(
        o, d, scene.arrays
    )
    return scene, hit, occluded


def test_hit_t_in_range(random_query):
    _, hit, _ = random_query
    t = np.asarray(hit.t)
    h = np.asarray(hit.hit)
    assert h.any(), "fuzz rays should hit something"
    assert (t[h] >= RAY_TMIN).all()
    assert (t[h] <= RAY_TMAX).all()
    np.testing.assert_array_equal(t[~h], RAY_TMAX)


def test_hit_normals_unit_and_facing(random_query):
    _, hit, _ = random_query
    h = np.asarray(hit.hit)
    n = np.asarray(hit.normal)[h]
    lens = np.linalg.norm(n, axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)


def test_geometry_ids_valid(random_query):
    scene, hit, _ = random_query
    g = np.asarray(hit.geometry_id)
    h = np.asarray(hit.hit)
    assert ((g[h] >= 0) & (g[h] <= scene.layout.plane_geometry_id)).all()
    assert (g[~h] == -1).all()


def test_closest_implies_occluded(random_query):
    _, hit, occluded = random_query
    h = np.asarray(hit.hit)
    occ = np.asarray(occluded)
    # Any ray with a valid closest hit must be reported occluded by the
    # any-hit query over the same extents.
    assert (occ[h]).all()


def test_miss_rays_pointing_up_at_sky():
    scene = builtin.build_scene(aspect=1.0, elapsed_time=0.0)
    o = jnp.asarray([[0.0, 30.0, 0.0]], dtype=jnp.float32)
    d = jnp.asarray([[0.0, 1.0, 0.0]], dtype=jnp.float32)
    hit = traverse.closest_hit(o, d, scene)
    assert not bool(hit.hit[0])
    occ = traverse.any_hit(o, d, scene)
    assert not bool(occ[0])
