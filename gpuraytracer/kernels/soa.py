"""Structure-of-arrays vector math + SDF library for the Pallas kernels.

A kernel block holds one value per lane; a trailing xyz axis of 3 would
break the power-of-two block shapes, so kernel code keeps positions as
three separate lane arrays wrapped in V3. The distance functions mirror
geometry/sdf.py formula-for-formula (reference anchors there);
tests/test_kernels.py pins the two implementations against each other on
sampled points.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from gpuraytracer.core.types import (
    FRACTAL_ITERATIONS_COUNT,
    SignedDistancePrimitive,
)
from gpuraytracer.geometry.fractal import (
    ExtendedSignedDistancePrimitive,
    JULIA_C,
    JULIA_ITERATIONS,
    MANDELBULB_BAILOUT,
    MANDELBULB_ITERATIONS,
    MANDELBULB_POWER,
)


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, s):
        if isinstance(s, V3):
            return V3(self.x * s.x, self.y * s.y, self.z * s.z)
        return V3(self.x * s, self.y * s, self.z * s)

    __radd__ = __add__
    __rmul__ = __mul__

    def dot(self, o) -> jnp.ndarray:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def length(self) -> jnp.ndarray:
        return jnp.sqrt(self.dot(self))

    def length_sq(self) -> jnp.ndarray:
        return self.dot(self)

    def abs(self) -> "V3":
        return V3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def max_scalar(self, v) -> "V3":
        return V3(jnp.maximum(self.x, v), jnp.maximum(self.y, v), jnp.maximum(self.z, v))

    def max_component(self) -> jnp.ndarray:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def normalized(self) -> "V3":
        # Exact-zero guard: zero vectors normalize to zero, not NaN (see
        # core/hlsl.normalize).
        inv = 1.0 / jnp.maximum(self.length(), 1e-20)
        return V3(self.x * inv, self.y * inv, self.z * inv)


def fmod(a, b):
    return jnp.fmod(a, b)


def op_rep(p: V3, cx, cy, cz) -> V3:
    return V3(
        fmod(p.x, cx) - 0.5 * cx,
        fmod(p.y, cy) - 0.5 * cy,
        fmod(p.z, cz) - 0.5 * cz,
    )


def length2(a, b):
    return jnp.sqrt(a * a + b * b)


def pow8_root(v):
    """v^(1/8) for v >= 0 via three square roots (exact same function as
    pow(v, 1/8) up to rounding; much cheaper than exp/log)."""
    return jnp.sqrt(jnp.sqrt(jnp.sqrt(v)))


def length_pow8(a, b):
    q = a * a
    q = q * q
    q = q * q
    r = b * b
    r = r * r
    r = r * r
    return pow8_root(q + r)


def sd_sphere(p: V3, r):
    return p.length() - r


def sd_box(p: V3, bx, by, bz):
    d = V3(jnp.abs(p.x) - bx, jnp.abs(p.y) - by, jnp.abs(p.z) - bz)
    outside = d.max_scalar(0.0).length()
    inside = jnp.minimum(d.max_component(), 0.0)
    return inside + outside


def ud_round_box(p: V3, b, r):
    d = V3(jnp.abs(p.x) - b, jnp.abs(p.y) - b, jnp.abs(p.z) - b)
    return d.max_scalar(0.0).length() - r


def sd_torus(p: V3, t0, t1):
    qx = length2(p.x, p.z) - t0
    return length2(qx, p.y) - t1


def sd_torus82(p: V3, t0, t1):
    qx = length2(p.x, p.z) - t0
    return length_pow8(qx, p.y) - t1


def sd_cylinder(p: V3, h0, h1):
    dx = jnp.abs(length2(p.x, p.z)) - h0
    dy = jnp.abs(p.y) - h1
    outside = length2(jnp.maximum(dx, 0.0), jnp.maximum(dy, 0.0))
    inside = jnp.minimum(jnp.maximum(dx, dy), 0.0)
    return inside + outside


def sd_octahedron(p: V3, hx, hy, hz):
    d = jnp.maximum(jnp.abs(p.x), jnp.abs(p.z)) * hx + jnp.abs(p.y) * hy
    return d - hy * hz


def sd_pyramid(p: V3, hx, hy, hz):
    return jnp.maximum(sd_octahedron(p, hx, hy, hz), -p.y)


def op_twist(p: V3) -> V3:
    c = jnp.cos(3.0 * p.y)
    s = jnp.sin(3.0 * p.y)
    return V3(c * p.x - s * p.z, s * p.x + c * p.z, p.y)


# ---------------------------------------------------------------------------
# Scene object distances (ProceduralPrimitivesLibrary.hlsli:63-98)
# ---------------------------------------------------------------------------

def distance_mini_spheres(p: V3):
    rep = op_rep(p + 1.0, 0.5, 0.5, 0.5)
    return jnp.maximum(sd_sphere(rep, 0.65 / 4.0), sd_box(p, 1.0, 1.0, 1.0))


def distance_intersected_round_cube(p: V3):
    inner = jnp.maximum(ud_round_box(p, 0.75, 0.2), -sd_sphere(p, 1.20))
    return jnp.maximum(inner, sd_sphere(p, 1.32))


def distance_square_torus(p: V3):
    return sd_torus82(p, 0.75, 0.15)


def distance_twisted_torus(p: V3):
    return sd_torus(op_twist(p), 0.6, 0.2)


def distance_cog(p: V3):
    ang = jnp.arctan2(p.z, p.x) / 6.2831
    polar = V3(ang, jnp.ones_like(p.x), 0.015 + 0.25 * p.length())
    teeth = sd_cylinder(op_rep(polar + 1.0, 0.05, 1.0, 0.075), 0.02, 0.8)
    return jnp.maximum(sd_torus82(p, 0.60, 0.3), -teeth)


def distance_cylinder(p: V3):
    q = p + 1.0
    return jnp.maximum(
        sd_cylinder(op_rep(q, 1.0, 2.0, 1.0), 0.3, 2.0),
        sd_box(q, 2.0, 2.0, 2.0),
    )


def distance_fractal_pyramid(p: V3):
    hx, hy, hz = 0.894, 0.447, 2.0
    scale = 2.0
    a = hz * hy / hx
    pos = V3(p.x, p.y + 1.0, p.z)
    verts = (
        (0.0, hz, 0.0),
        (-a, 0.0, a),
        (a, 0.0, -a),
        (a, 0.0, a),
        (-a, 0.0, -a),
    )
    for _ in range(FRACTAL_ITERATIONS_COUNT):
        # Closest of the 5 fold vertices (apex + 4 base corners). The
        # closest base corner separates per axis: dist^2 = (x -+ a)^2 +
        # y^2 + (z -+ a)^2, so it is (sign(x)a, 0, sign(z)a) — two selects
        # replace four length_sq comparisons. Equivalent to the ordered
        # strict-< scan everywhere except exact-zero coordinate ties
        # (measure-zero; the XLA reference path keeps the ordered scan).
        bx = jnp.where(pos.x > 0.0, a, -a)
        bz = jnp.where(pos.z > 0.0, a, -a)
        d_base = (pos - V3(bx, jnp.zeros_like(bx), bz)).length_sq()
        d_apex = (pos - V3(*verts[0])).length_sq()
        # The ordered scan seeds with the apex and replaces on STRICT <,
        # so the apex wins distance ties.
        apex = d_apex <= d_base
        best_x = jnp.where(apex, verts[0][0], bx)
        best_y = jnp.where(apex, verts[0][1], 0.0)
        best_z = jnp.where(apex, verts[0][2], bz)
        pos = V3(
            scale * pos.x - best_x * (scale - 1.0),
            scale * pos.y - best_y * (scale - 1.0),
            scale * pos.z - best_z * (scale - 1.0),
        )
    return sd_pyramid(pos, hx, hy, hz) * (scale ** (-float(FRACTAL_ITERATIONS_COUNT)))


def distance_mandelbulb(p: V3):
    """Mirror of geometry/fractal.py:distance_mandelbulb (SoA, unrolled):
    the trig-free polynomial power-8 map — ~80 flops per iteration vs the
    acos/atan2/sincos spherical form."""
    scale = 1.2
    pos = p * scale
    wx, wy, wz = pos.x, pos.y, pos.z
    dz = jnp.ones_like(wx)
    m = wx * wx + wy * wy + wz * wz
    escaped = wx > jnp.inf  # all False
    b2 = MANDELBULB_BAILOUT * MANDELBULB_BAILOUT

    for _ in range(MANDELBULB_ITERATIONS):
        frozen = escaped | (m > b2)

        m2 = m * m
        m4 = m2 * m2
        dz_new = 8.0 * jnp.sqrt(m4 * m2 * m) * dz + 1.0

        x, y, z = wx, wy, wz
        x2 = x * x
        x4 = x2 * x2
        y2 = y * y
        y4 = y2 * y2
        z2 = z * z
        z4 = z2 * z2
        k3 = x2 + z2
        k3_7 = k3 * k3 * k3 * k3 * k3 * k3 * k3
        k2 = 1.0 / jnp.sqrt(jnp.maximum(k3_7, 1e-30))
        k1 = x4 + y4 + z4 - 6.0 * y2 * z2 - 6.0 * x2 * y2 + 2.0 * z2 * x2
        k4 = x2 - y2 + z2
        nx = pos.x + 64.0 * x * y * z * (x2 - z2) * k4 * (
            x4 - 6.0 * x2 * z2 + z4
        ) * k1 * k2
        ny = pos.y + -16.0 * y2 * k3 * k4 * k4 + k1 * k1
        nz = pos.z + -8.0 * y * k4 * (
            x4 * x4 - 28.0 * x4 * x2 * z2 + 70.0 * x4 * z4
            - 28.0 * x2 * z2 * z4 + z4 * z4
        ) * k1 * k2

        wx = jnp.where(frozen, wx, nx)
        wy = jnp.where(frozen, wy, ny)
        wz = jnp.where(frozen, wz, nz)
        dz = jnp.where(frozen, dz, dz_new)
        m = jnp.where(frozen, m, wx * wx + wy * wy + wz * wz)
        escaped = frozen

    m = jnp.maximum(m, 1e-18)
    return (0.25 * jnp.log(m) * jnp.sqrt(m) / dz) / scale


def distance_julia_quaternion(p: V3):
    """Mirror of geometry/fractal.py:distance_julia_quaternion (SoA)."""
    scale = 1.1
    cw, cx, cy, cz = JULIA_C
    # Component packing matches fractal.py exactly: z0 = [pos.x, pos.y,
    # pos.z, 0] with _quat_mul treating index 0 as the scalar part, and
    # dz0 = [1, 0, 0, 0].
    aw, ax, ay, az = p.x * scale, p.y * scale, p.z * scale, jnp.zeros_like(p.x)
    bw = jnp.ones_like(p.x)
    bx = jnp.zeros_like(p.x)
    by = jnp.zeros_like(p.x)
    bz = jnp.zeros_like(p.x)
    escaped = p.x > jnp.inf

    def qmul(aw, ax, ay, az, bw, bx, by, bz):
        return (
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        )

    for _ in range(JULIA_ITERATIONS):
        m2 = aw * aw + ax * ax + ay * ay + az * az
        escaped = escaped | (m2 > 16.0)
        frozen = escaped
        nbw, nbx, nby, nbz = qmul(aw, ax, ay, az, bw, bx, by, bz)
        nbw, nbx, nby, nbz = 2.0 * nbw, 2.0 * nbx, 2.0 * nby, 2.0 * nbz
        naw, nax, nay, naz = qmul(aw, ax, ay, az, aw, ax, ay, az)
        naw, nax, nay, naz = naw + cw, nax + cx, nay + cy, naz + cz
        aw = jnp.where(frozen, aw, naw)
        ax = jnp.where(frozen, ax, nax)
        ay = jnp.where(frozen, ay, nay)
        az = jnp.where(frozen, az, naz)
        bw = jnp.where(frozen, bw, nbw)
        bx = jnp.where(frozen, bx, nbx)
        by = jnp.where(frozen, by, nby)
        bz = jnp.where(frozen, bz, nbz)

    mz = jnp.maximum(jnp.sqrt(aw * aw + ax * ax + ay * ay + az * az), 1e-9)
    mdz = jnp.maximum(jnp.sqrt(bw * bw + bx * bx + by * by + bz * bz), 1e-6)
    de = 0.5 * mz * jnp.log(mz) / mdz
    return jnp.where(escaped, de, -1e-3) / scale


DISTANCE_FUNCTIONS_SOA = {
    int(SignedDistancePrimitive.MINI_SPHERES): distance_mini_spheres,
    int(SignedDistancePrimitive.INTERSECTED_ROUND_CUBE): distance_intersected_round_cube,
    int(SignedDistancePrimitive.SQUARE_TORUS): distance_square_torus,
    int(SignedDistancePrimitive.TWISTED_TORUS): distance_twisted_torus,
    int(SignedDistancePrimitive.COG): distance_cog,
    int(SignedDistancePrimitive.CYLINDER): distance_cylinder,
    int(SignedDistancePrimitive.FRACTAL_PYRAMID): distance_fractal_pyramid,
    int(ExtendedSignedDistancePrimitive.MANDELBULB): distance_mandelbulb,
    int(ExtendedSignedDistancePrimitive.JULIA_QUATERNION): distance_julia_quaternion,
}
