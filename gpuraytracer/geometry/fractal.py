"""Extended distance-estimated fractals: Mandelbulb and quaternion Julia.

The reference ships one fractal (the Sierpinski-style pyramid,
SignedDistanceFractals.hlsli:34-63, reproduced in sdf.sd_fractal_pyramid).
BASELINE.json config #5 calls for a "Mandelbulb/Julia quaternion scene",
so the framework extends the SDF registry with the two classic
distance-estimated fractals (standard public formulas: triplex power-8
Mandelbulb and quaternion z^2+c Julia with running-derivative DE).

These are EXTENSIONS beyond the reference feature set; they plug into the
same sphere-trace intersector and scene-builder machinery as every other
signed-distance primitive.
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

from gpuraytracer.core import hlsl


class ExtendedSignedDistancePrimitive(enum.IntEnum):
    """Extended type codes, continuing after SignedDistancePrimitive
    (0..6 in ConstantBuffers.h:163-178)."""

    MANDELBULB = 7
    JULIA_QUATERNION = 8


MANDELBULB_ITERATIONS = 8
MANDELBULB_POWER = 8.0
MANDELBULB_BAILOUT = 2.0

JULIA_ITERATIONS = 11
# A visually pleasing, connected Julia set constant.
JULIA_C = (-0.2, 0.6, 0.2, 0.2)


def distance_mandelbulb(p):
    """Power-8 triplex Mandelbulb distance estimate, scaled to live inside
    the unit AABB (the bulb has radius ~1.2, so positions scale by 1.2).

    Uses the trig-free polynomial form of the power-8 map (the standard
    public formulation, e.g. iq's shadertoy "mandelbulb"): the spherical
    (r, 8*theta, 8*phi) update expands to polynomials in x, y, z, which
    costs ~80 flops per iteration instead of acos + atan2 + sincos + pow.
    DE = 0.25 * log(m) * sqrt(m) / dz with the scalar running derivative
    dz <- 8 * m^3.5 * dz + 1 (identical to 0.5 log r * r / dr, m = r^2).
    """
    scale = 1.2
    pos = p * scale
    px, py_, pz = pos[..., 0], pos[..., 1], pos[..., 2]

    def body(_, state):
        wx, wy, wz, dz, m, escaped = state
        frozen = escaped | (m > MANDELBULB_BAILOUT * MANDELBULB_BAILOUT)

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
        nx = px + 64.0 * x * y * z * (x2 - z2) * k4 * (
            x4 - 6.0 * x2 * z2 + z4
        ) * k1 * k2
        ny = py_ + -16.0 * y2 * k3 * k4 * k4 + k1 * k1
        nz = pz + -8.0 * y * k4 * (
            x4 * x4 - 28.0 * x4 * x2 * z2 + 70.0 * x4 * z4
            - 28.0 * x2 * z2 * z4 + z4 * z4
        ) * k1 * k2

        wx = jnp.where(frozen, wx, nx)
        wy = jnp.where(frozen, wy, ny)
        wz = jnp.where(frozen, wz, nz)
        dz = jnp.where(frozen, dz, dz_new)
        m = jnp.where(frozen, m, wx * wx + wy * wy + wz * wz)
        return wx, wy, wz, dz, m, frozen

    dz0 = jnp.ones(pos.shape[:-1], dtype=pos.dtype)
    m0 = px * px + py_ * py_ + pz * pz
    escaped0 = jnp.zeros(pos.shape[:-1], dtype=bool)
    _, _, _, dz, m, _ = jax.lax.fori_loop(
        0, MANDELBULB_ITERATIONS, body, (px, py_, pz, dz0, m0, escaped0)
    )

    m = jnp.maximum(m, 1e-18)
    de = 0.25 * jnp.log(m) * jnp.sqrt(m) / dz
    return de / scale


def _quat_mul(a, b):
    """Hamilton product over trailing-axis-4 quaternions (w, x, y, z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def distance_julia_quaternion(p, c=JULIA_C):
    """Quaternion Julia set z <- z^2 + c on the w=0 slice, DE =
    0.5 * |z| * log|z| / |dz| with the quaternion running derivative
    dz <- 2 z dz. Scaled to sit inside the unit AABB."""
    scale = 1.1
    pos = p * scale
    c = jnp.asarray(c, dtype=p.dtype)

    z0 = jnp.concatenate([pos, jnp.zeros(pos.shape[:-1] + (1,), dtype=p.dtype)], axis=-1)
    dz0 = jnp.concatenate(
        [
            jnp.ones(pos.shape[:-1] + (1,), dtype=p.dtype),
            jnp.zeros(pos.shape[:-1] + (3,), dtype=p.dtype),
        ],
        axis=-1,
    )
    escaped0 = jnp.zeros(pos.shape[:-1], dtype=bool)

    def body(_, state):
        z, dz, escaped = state
        m2 = hlsl.dot(z, z)
        esc_now = m2 > 16.0
        escaped = escaped | esc_now
        frozen = escaped
        dz_new = 2.0 * _quat_mul(z, dz)
        z_new = _quat_mul(z, z) + c
        z = jnp.where(frozen[..., None], z, z_new)
        dz = jnp.where(frozen[..., None], dz, dz_new)
        return z, dz, escaped

    z, dz, escaped = jax.lax.fori_loop(
        0, JULIA_ITERATIONS, body, (z0, dz0, escaped0)
    )

    mz = jnp.maximum(hlsl.length(z), 1e-9)
    mdz = jnp.maximum(hlsl.length(dz), 1e-6)
    de = 0.5 * mz * jnp.log(mz) / mdz
    # Non-escaping points lie in the filled Julia set; the DE formula
    # degenerates there (|dz| can collapse), so report a small negative
    # distance — "just inside" — which the sphere tracer treats as a hit
    # without taking an explosive negative step.
    return jnp.where(escaped, de, -1e-3) / scale


def register():
    """Install the extended fractals into the SDF dispatch table. DE
    fractals make no escape-envelope claim — their marches are
    AABB-windowed (accel/traverse.py, codes >= 7)."""
    from gpuraytracer.geometry import sdf

    sdf.register_distance_function(
        int(ExtendedSignedDistancePrimitive.MANDELBULB),
        distance_mandelbulb, aabb_windowed=True,
    )
    sdf.register_distance_function(
        int(ExtendedSignedDistancePrimitive.JULIA_QUATERNION),
        distance_julia_quaternion, aabb_windowed=True,
    )


register()
