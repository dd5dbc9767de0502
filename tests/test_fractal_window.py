"""AABB-windowed march semantics for extension DE fractals (codes >= 7).

Extension primitives are DEFINED clipped to their instance AABB: the
sphere-trace window is [max(entry, 0), min(exit, RayTCurrent)]
(accel/traverse.py, kernels/sdf_march.py). Reference primitives keep
march-from-zero parity and are untouched (pinned by the golden suite).
"""

import jax.numpy as jnp
import numpy as np

from gpuraytracer.accel import traverse
from gpuraytracer.core.types import IntersectorKind
from gpuraytracer.geometry.fractal import ExtendedSignedDistancePrimitive
from gpuraytracer.models.builder import InstanceSpec, Material, SceneBuilder


def _bulb_scene():
    b = SceneBuilder()
    b.add_instance(
        InstanceSpec(
            kind=IntersectorKind.SIGNED_DISTANCE,
            prim_type=int(ExtendedSignedDistancePrimitive.MANDELBULB),
            aabb_min=(-1.0, 0.0, -1.0),
            aabb_max=(1.0, 2.0, 1.0),
            material=Material((0.2, 0.8, 0.4, 1.0), 0.0, 1.0, 0.4, 10.0, 0.6),
            scale=(1.0, 1.0, 1.0),
        )
    )
    return b.build(aspect=1.0, elapsed_time=0.0)


def test_window_hits_inside_aabb_only():
    scene = _bulb_scene()
    # World-space box center: the BLAS offset lifts procedural instances
    # by aabb_width/2 (= +1 in y), and the box spans y in [0, 2] in BLAS
    # space -> world center at y = 2.
    o = jnp.asarray([
        [0.0, 2.0, -5.0],   # straight through the bulb center -> hit
        [0.0, 6.0, -5.0],   # passes far above the box -> miss
    ], dtype=jnp.float32)
    d = jnp.asarray([
        [0.0, 0.0, 1.0],
        [0.0, 0.0, 1.0],
    ], dtype=jnp.float32)
    hit = traverse.closest_hit(o, d, scene)
    h = np.asarray(hit.hit)
    t = np.asarray(hit.t)
    assert h[0] and not h[1]
    # The hit parameter lies inside the window [entry, exit]: the box
    # spans z in [-1, 1] at distance 5 -> t in [4, 6].
    assert 4.0 <= t[0] <= 6.0
    # Normal faces the ray.
    n = np.asarray(hit.normal)[0]
    assert n @ np.asarray([0.0, 0.0, 1.0]) < 0.0
