"""Kernel tests: the SoA distance library against the AoS one, and the
Triton march (kernels/sdf_march.py) against the XLA reference march
(geometry/sdf.sphere_trace), in interpret mode on the CPU. The compiled
kernel runs only on the card (tests marked `gpu`)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.core.types import SignedDistancePrimitive
from gpuraytracer.geometry import analytic, sdf
from gpuraytracer.geometry.fractal import ExtendedSignedDistancePrimitive
from gpuraytracer.kernels import sdf_march, soa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sample_points(rng):
    pts = rng.uniform(-1.5, 1.5, size=(256, 3)).astype(np.float32)
    return jnp.asarray(pts)


ALL_CODES = [int(p) for p in SignedDistancePrimitive] + [
    int(ExtendedSignedDistancePrimitive.MANDELBULB),
    int(ExtendedSignedDistancePrimitive.JULIA_QUATERNION),
]


@pytest.mark.parametrize("code", ALL_CODES)
def test_soa_matches_aos(code, sample_points):
    """The SoA (kernel) distance functions must match the AoS (XLA)
    implementations. torus82's x^(1/8) uses 3 sqrts instead of pow in the
    SoA form, so tolerance is loose-ulp rather than exact."""
    p = sample_points
    aos = np.asarray(sdf.DISTANCE_FUNCTIONS[code](p))
    v = soa.V3(p[:, 0], p[:, 1], p[:, 2])
    s = np.asarray(soa.DISTANCE_FUNCTIONS_SOA[code](v))
    np.testing.assert_allclose(s, aos, rtol=2e-5, atol=2e-5)


def test_pow8_root():
    v = jnp.asarray([0.0, 1.0, 256.0, 1e-6], dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(soa.pow8_root(v)), np.power(np.asarray(v), 0.125), rtol=1e-6
    )


# ---------------------------------------------------------------------------
# The Triton march against the XLA march (interpret mode)
# ---------------------------------------------------------------------------


def _grid_rays(h=16, w=128, z=-5.0, tilt=0.0):
    ys, xs = jnp.meshgrid(
        jnp.linspace(-1.2, 1.2, h), jnp.linspace(-1.2, 1.2, w), indexing="ij"
    )
    o = jnp.stack([xs, ys, jnp.full_like(xs, z)], axis=-1)
    d = jnp.stack([tilt * xs, tilt * ys, jnp.ones_like(xs)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _march_args(code, o, d, occlusion):
    """The per-geometry march arguments as accel/traverse.py builds them:
    extension codes are AABB-windowed, unculled and over-relaxed;
    occlusion marches run a reduced budget with conservative capped hits."""
    gate = jnp.ones(o.shape[:-1], bool)
    t_lo = jnp.zeros(gate.shape, jnp.float32)
    t_hi = jnp.full(gate.shape, 1e4, jnp.float32)
    cull = not occlusion
    if code >= 7:
        w_lo, w_hi = analytic.aabb_interval(o, d, (-1.0,) * 3, (1.0,) * 3)
        t_lo = jnp.maximum(w_lo, 0.0)
        t_hi = jnp.minimum(t_hi, w_hi)
        gate = gate & (w_hi > w_lo) & (t_hi > t_lo)
        cull = False
    return dict(
        gate=gate, t_lo=t_lo, t_hi=t_hi, cull=cull,
        relax=1.6 if (occlusion or code >= 7) else 1.0,
        escape=code in sdf.ESCAPE_SAFE_CODES and code < 7,
        steps=24 if occlusion else 160, capped=occlusion,
    )


def _kernel(code, o, d, a, step_scale=1.0):
    return tuple(map(np.asarray, sdf_march.sphere_trace_lanes(
        o, d, a["gate"], a["t_lo"], a["t_hi"], step_scale, a["steps"],
        a["capped"], prim_code=code, cull_backface=a["cull"],
        escape_bound=a["escape"], relax=a["relax"], interpret=True,
    )))


def _reference(code, o, d, a, step_scale=1.0):
    fn = sdf.DISTANCE_FUNCTIONS[code]
    return tuple(map(np.asarray, jax.jit(
        lambda o, d, g, lo, hi: sdf.sphere_trace(
            o, d, fn, step_scale=step_scale, t_min=lo, t_max=hi,
            cull_backface=a["cull"], active=g, max_steps=a["steps"],
            escape_bound=a["escape"], relax=a["relax"],
            capped_hit=a["capped"],
        )
    )(o, d, a["gate"], a["t_lo"], a["t_hi"])))


def _assert_agree(kernel, ref, normals=True):
    hit_k, t_k, n_k = kernel
    hit_x, t_x, n_x = ref
    assert (hit_k == hit_x).mean() >= 0.999
    both = hit_k & hit_x
    assert both.any()
    np.testing.assert_allclose(t_k[both], t_x[both], atol=1e-4)
    if normals:
        # The tetrahedral gradient divides distance differences by its
        # 5.8e-5 offset, so a one-ulp difference between the SoA and AoS
        # distance forms moves a normal by ~1e-3; the cog's polar teeth
        # amplify that about four-fold.
        np.testing.assert_allclose(n_k[both], n_x[both], atol=1e-2)


@pytest.mark.parametrize("code", ALL_CODES)
def test_closest_hit_march_matches_reference(code):
    o, d = _grid_rays(z=-3.0 if code >= 7 else -5.0)
    a = _march_args(code, o, d, occlusion=False)
    _assert_agree(_kernel(code, o, d, a), _reference(code, o, d, a))


@pytest.mark.parametrize("code", ALL_CODES)
def test_capped_occlusion_march_matches_reference(code):
    """Shadow-ray form: reduced budget, over-relaxed, budget-exhausted
    lanes report occluded. Only the hit mask is consumed."""
    o, d = _grid_rays(z=-3.0 if code >= 7 else -5.0, tilt=0.2)
    a = _march_args(code, o, d, occlusion=True)
    _assert_agree(_kernel(code, o, d, a), _reference(code, o, d, a),
                  normals=False)


@pytest.mark.parametrize("code", ALL_CODES)
def test_march_lowers_for_cuda(code):
    """The kernel lowers to a Triton call for CUDA on a host with no GPU
    (what the card's compiler then refuses shows only on the card)."""
    o, d = _grid_rays(h=8)
    a = _march_args(code, o, d, occlusion=False)

    def f(o, d, gate, lo, hi, steps):
        return sdf_march.sphere_trace_lanes(
            o, d, gate, lo, hi, 0.8, steps, True, prim_code=code,
            cull_backface=a["cull"], escape_bound=a["escape"],
            relax=a["relax"],
        )

    lowered = jax.jit(f).trace(
        o, d, a["gate"], a["t_lo"], a["t_hi"], jnp.int32(96)
    ).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" in lowered.as_text()


@pytest.mark.parametrize("level", [0, 1])
def test_traced_level_budget(level):
    """The per-level budget arrives traced, as accel/traverse.py selects it
    from the scanned level index; the kernel must honor it like the
    reference does with the same budget."""
    code = int(SignedDistancePrimitive.FRACTAL_PYRAMID)
    o, d = _grid_rays()
    a = _march_args(code, o, d, occlusion=True)
    budgets = (24, 6)

    @jax.jit
    def run(lvl):
        steps = jnp.where(lvl == 0, jnp.int32(budgets[0]), jnp.int32(budgets[1]))
        return sdf_march.sphere_trace_lanes(
            o, d, a["gate"], a["t_lo"], a["t_hi"], 1.0, steps, True,
            prim_code=code, cull_backface=a["cull"], escape_bound=a["escape"],
            relax=a["relax"], interpret=True,
        )

    got = tuple(map(np.asarray, run(jnp.int32(level))))
    ref = _reference(code, o, d, dict(a, steps=budgets[level]))
    _assert_agree(got, ref, normals=False)
    if level == 1:
        # The tighter bounce budget really applies: more capped lanes.
        other = np.asarray(run(jnp.int32(0))[0])
        assert got[0].sum() > other.sum()


class TestTileKernelInterpret:
    """Kernel semantics vs the XLA wavefront path, via interpret mode."""

    def _rays(self):
        H, W = 16, 128
        o, d = _grid_rays(H, W)
        gate = jnp.ones((H, W), dtype=bool)
        tmax = jnp.full((H, W), 1e4, dtype=jnp.float32)
        return o, d, gate, tmax

    def test_matches_xla_path(self):
        o, d, gate, tmax = self._rays()
        code = int(SignedDistancePrimitive.FRACTAL_PYRAMID)
        hit_p, t_p, n_p = map(
            np.asarray,
            sdf_march.sphere_trace_lanes(
                o, d, gate, 0.0, tmax, 0.8, 512, prim_code=code,
                interpret=True,
            ),
        )
        fn = sdf.DISTANCE_FUNCTIONS[code]
        hit_x, t_x, n_x = map(
            np.asarray,
            jax.jit(
                lambda o, d, g, tm: sdf.sphere_trace(
                    o, d, fn, step_scale=0.8, t_max=tm,
                    cull_backface=True, active=g,
                )
            )(o, d, gate, tmax),
        )
        assert (hit_p == hit_x).all()
        m = hit_p
        assert m.any()
        np.testing.assert_allclose(t_p[m], t_x[m], atol=1e-5)
        # Tetrahedral-gradient normals amplify last-ulp differences in the
        # distance eval (fma fusion differs between paths); 1e-3 is the
        # radiance parity budget.
        np.testing.assert_allclose(n_p[m], n_x[m], atol=1e-3)

    def test_gate_masks_out(self):
        o, d, gate, tmax = self._rays()
        gate = gate & False
        hit, t, _ = sdf_march.sphere_trace_lanes(
            o, d, gate, 0.0, tmax, 1.0, 512,
            prim_code=int(SignedDistancePrimitive.SQUARE_TORUS), interpret=True,
        )
        assert not bool(np.asarray(hit).any())

    def test_unaligned_shapes_padded(self):
        H, W = 13, 57  # not block multiples
        o = jnp.zeros((H, W, 3), dtype=jnp.float32).at[..., 2].set(-5.0)
        d = jnp.zeros((H, W, 3), dtype=jnp.float32).at[..., 2].set(1.0)
        gate = jnp.ones((H, W), dtype=bool)
        tmax = jnp.full((H, W), 1e4, dtype=jnp.float32)
        hit, t, n = sdf_march.sphere_trace_lanes(
            o, d, gate, 0.0, tmax, 1.0, 512,
            prim_code=int(SignedDistancePrimitive.SQUARE_TORUS), interpret=True,
        )
        assert hit.shape == (H, W) and n.shape == (H, W, 3)
        # Head-on ray through the torus ring (x=z=0 -> qx=-0.75, |(qx,y)|_8
        # - 0.15 > 0 at center... the center column passes through the
        # hole) — just require the kernel to be finite & consistent.
        assert np.isfinite(np.asarray(t)[np.asarray(hit)]).all()


def test_relaxed_kernel_matches_relaxed_xla():
    """The in-kernel over-relaxed march (relax=...) implements the same
    Keinert-style algorithm as sdf.sphere_trace(relax=...): same overshoot
    test, same backstep, same retire-on-unrelaxed-reach. On the mandelbulb
    (the production user) the two paths must agree like the plain marchers
    do."""
    H, W = 16, 128
    o, d = _grid_rays(H, W, z=-3.0)
    gate = jnp.ones((H, W), dtype=bool)
    tmax = jnp.full((H, W), 1e4, dtype=jnp.float32)
    code = int(ExtendedSignedDistancePrimitive.MANDELBULB)
    hit_p, t_p, _ = map(
        np.asarray,
        sdf_march.sphere_trace_lanes(
            o, d, gate, 0.0, tmax, 1.0, 512, prim_code=code,
            cull_backface=False, escape_bound=False, relax=1.6,
            interpret=True,
        ),
    )
    fn = sdf.DISTANCE_FUNCTIONS[code]
    hit_x, t_x, _ = map(
        np.asarray,
        jax.jit(
            lambda o, d, g, tm: sdf.sphere_trace(
                o, d, fn, step_scale=1.0, t_max=tm, cull_backface=False,
                active=g, escape_bound=False, relax=1.6,
            )
        )(o, d, gate, tmax),
    )
    assert (hit_p == hit_x).mean() > 0.999
    m = hit_p & hit_x
    assert m.any()
    np.testing.assert_allclose(t_p[m], t_x[m], atol=1e-4)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

_GPU_SRC = """
import jax, jax.numpy as jnp, numpy as np
from gpuraytracer.geometry import sdf
from gpuraytracer.kernels import sdf_march
assert jax.default_backend() == "gpu", jax.devices()
h, w = 64, 256
ys, xs = jnp.meshgrid(jnp.linspace(-1.2, 1.2, h), jnp.linspace(-1.2, 1.2, w),
                      indexing="ij")
o = jnp.stack([xs, ys, jnp.full_like(xs, -5.0)], axis=-1)
d = jnp.zeros_like(o).at[..., 2].set(1.0)
g = jnp.ones((h, w), bool)
for code in range(7):
    fn = sdf.DISTANCE_FUNCTIONS[code]
    hk, tk, _ = sdf_march.sphere_trace_lanes(o, d, g, 0.0, 1e4, 1.0, 160,
                                             prim_code=code)
    hx, tx, _ = jax.jit(lambda o, d: sdf.sphere_trace(
        o, d, fn, t_max=1e4, cull_backface=True, max_steps=160))(o, d)
    hk, hx = np.asarray(hk), np.asarray(hx)
    assert (hk == hx).mean() >= 0.999, code
    both = hk & hx
    assert np.abs(np.asarray(tk)[both] - np.asarray(tx)[both]).max() < 1e-4
print("ok")
"""


@pytest.mark.gpu
def test_compiled_march_matches_reference_on_gpu(card):
    proc = subprocess.run(
        [sys.executable, "-c", _GPU_SRC], env=card, cwd=REPO,
        capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
