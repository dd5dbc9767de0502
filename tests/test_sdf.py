"""SDF library + sphere tracer unit tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.geometry import sdf

TMAX = 10000.0


def _p(*xyz):
    return jnp.asarray([xyz], dtype=jnp.float32)


def _ray(o, d):
    return (
        jnp.asarray([o], dtype=jnp.float32),
        jnp.asarray([d], dtype=jnp.float32),
    )


@functools.partial(
    jax.jit, static_argnames=("distance_fn", "step_scale", "t_max", "cull_backface")
)
def _trace(o, d, distance_fn, step_scale=1.0, t_max=TMAX, cull_backface=True, active=None):
    # fori_loop outside jit dispatches eagerly and is pathologically slow;
    # production paths are always jitted, so tests are too.
    return sdf.sphere_trace(
        o, d, distance_fn, step_scale=step_scale, t_max=t_max,
        cull_backface=cull_backface, active=active,
    )


class TestPrimitives:
    def test_sphere(self):
        assert float(sdf.sd_sphere(_p(0, 0, 2), 1.0)[0]) == pytest.approx(1.0)
        assert float(sdf.sd_sphere(_p(0, 0, 0), 1.0)[0]) == pytest.approx(-1.0)

    def test_box(self):
        assert float(sdf.sd_box(_p(2, 0, 0), (1, 1, 1))[0]) == pytest.approx(1.0)
        assert float(sdf.sd_box(_p(0, 0, 0), (1, 1, 1))[0]) == pytest.approx(-1.0)
        # Corner distance: diagonal
        assert float(sdf.sd_box(_p(2, 2, 2), (1, 1, 1))[0]) == pytest.approx(
            np.sqrt(3.0), abs=1e-5
        )

    def test_torus(self):
        # Point on the ring circle at radius 0.6: distance = -tube radius
        assert float(sdf.sd_torus(_p(0.6, 0, 0), (0.6, 0.2))[0]) == pytest.approx(-0.2)
        # Center of torus: distance = ring radius - tube
        assert float(sdf.sd_torus(_p(0, 0, 0), (0.6, 0.2))[0]) == pytest.approx(0.4)

    def test_torus82_square_profile(self):
        d = float(sdf.sd_torus82(_p(0.75, 0, 0), (0.75, 0.15))[0])
        assert d == pytest.approx(-0.15, abs=1e-6)

    def test_cylinder(self):
        assert float(sdf.sd_cylinder(_p(1.0, 0, 0), (0.3, 2.0))[0]) == pytest.approx(0.7)
        assert float(sdf.sd_cylinder(_p(0, 3.0, 0), (0.3, 2.0))[0]) == pytest.approx(1.0)

    def test_round_box(self):
        assert float(sdf.ud_round_box(_p(2, 0, 0), (0.75,) * 3, 0.2)[0]) == pytest.approx(
            2 - 0.75 - 0.2, abs=1e-6
        )

    def test_octahedron_and_pyramid(self):
        h = (0.894, 0.447, 2.0)
        # Apex of the pyramid (0, 2, 0): octahedron dist = |y|*cos - cos*h
        apex = float(sdf.sd_pyramid(_p(0, 2, 0), h)[0])
        assert apex == pytest.approx(0.0, abs=1e-6)
        # Below ground is cut: opS(octa, y) = max(octa, -y) > 0 for y < 0
        assert float(sdf.sd_pyramid(_p(0, -0.5, 0), h)[0]) > 0

    def test_op_rep_fmod_semantics(self):
        # opRep with HLSL fmod: for p in (-c, 0), fmod(p,c) = p (negative),
        # so opRep(p) = p - 0.5c — NOT symmetric like euclidean mod. This is
        # the exact behavior the scene geometry depends on.
        p = _p(-0.25, 0.0, 0.25)
        out = np.asarray(sdf.op_rep(p, (1.0, 1.0, 1.0)))[0]
        np.testing.assert_allclose(out, [-0.75, -0.5, -0.25], atol=1e-6)

    def test_twist_rotates_xz_by_3y(self):
        p = _p(1.0, 0.0, 0.0)  # y = 0 -> no rotation
        np.testing.assert_allclose(np.asarray(sdf.op_twist(p))[0], [1, 0, 0], atol=1e-6)
        p = _p(1.0, np.pi / 6.0, 0.0)  # angle = 3*y = pi/2
        out = np.asarray(sdf.op_twist(p))[0]
        np.testing.assert_allclose(out, [0.0, 1.0, np.pi / 6.0], atol=1e-5)


class TestSceneObjects:
    """Sanity: each composed object is solid somewhere inside the unit AABB
    and positive well outside it."""

    @pytest.mark.parametrize(
        "fn,inside_point",
        [
            (sdf.distance_mini_spheres, (-0.75, -0.75, -0.75)),
            # Solid region is the corner shell between radii 1.20 and 1.32:
            # |p| ~ 1.26 along a diagonal.
            (sdf.distance_intersected_round_cube, (0.7275, 0.7275, 0.7275)),
            (sdf.distance_square_torus, (0.75, 0.0, 0.0)),
            (sdf.distance_twisted_torus, (0.6, 0.0, 0.0)),
            (sdf.distance_cog, (0.6, 0.0, 0.0)),
            # Cylinder axes sit where opRep(p+1, (1,2,1)).xz == 0, e.g.
            # p = (-0.5, 0, -0.5).
            (sdf.distance_cylinder, (-0.5, 0.0, -0.5)),
            # The Sierpinski fold hollows out the base center; a corner
            # sub-pyramid point survives all 4 folds.
            (sdf.distance_fractal_pyramid, (0.9, -0.98, 0.9)),
        ],
    )
    def test_inside_negative_outside_positive(self, fn, inside_point):
        assert float(fn(_p(*inside_point))[0]) < 0.0
        assert float(fn(_p(5.0, 5.0, 5.0))[0]) > 0.0

    def test_mini_spheres_lattice(self):
        # Sphere centers sit at opRep(p+1, 0.5) == 0, radius 0.1625.
        # p = -1 + 0.25 = -0.75 is a center (fmod(0.25, 0.5) - 0.25 = 0).
        d = float(sdf.distance_mini_spheres(_p(-0.75, -0.75, -0.75))[0])
        assert d == pytest.approx(-0.65 / 4.0, abs=1e-6)

    def test_fractal_pyramid_apex(self):
        # The fractal keeps the pyramid envelope: apex at local y=1
        # (position + (0,1,0) puts base at y=-1, height 2).
        d = float(sdf.distance_fractal_pyramid(_p(0.0, 1.0, 0.0))[0])
        assert abs(d) < 1e-3


def _UNIT_SPHERE(p):
    return sdf.sd_sphere(p, 1.0)


class TestSphereTrace:
    def test_unit_sphere_head_on(self):
        o, d = _ray((0, 0, -5), (0, 0, 1))
        hit, t, n = _trace(o, d, _UNIT_SPHERE)
        assert bool(hit[0])
        # Relative threshold 1e-4*t at t~4 -> within ~4e-4 of the surface.
        assert float(t[0]) == pytest.approx(4.0, abs=2e-3)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-2)

    def test_miss_escapes(self):
        o, d = _ray((0, 5, -5), (0, 0, 1))
        hit, t, _ = _trace(o, d, _UNIT_SPHERE)
        assert not bool(hit[0])
        assert np.isinf(float(t[0]))

    def test_step_scale_still_converges(self):
        o, d = _ray((0, 0, -5), (0, 0, 1))
        hit, t, _ = _trace(o, d, _UNIT_SPHERE, step_scale=0.5)
        assert bool(hit[0])
        assert float(t[0]) == pytest.approx(4.0, abs=2e-3)

    def test_active_mask_disables_lanes(self):
        o = jnp.asarray([(0, 0, -5), (0, 0, -5)], dtype=jnp.float32)
        d = jnp.asarray([(0, 0, 1), (0, 0, 1)], dtype=jnp.float32)
        active = jnp.asarray([True, False])
        hit, _, _ = _trace(o, d, _UNIT_SPHERE, active=active)
        assert bool(hit[0]) and not bool(hit[1])

    def test_t_max_respected(self):
        o, d = _ray((0, 0, -5), (0, 0, 1))
        hit, _, _ = _trace(o, d, _UNIT_SPHERE, t_max=2.0)
        assert not bool(hit[0])


def test_calculate_normal_matches_gradient():
    fn = lambda p: sdf.sd_sphere(p, 1.0)
    pos = _p(0.0, 1.0, 0.0)
    n = np.asarray(sdf.calculate_normal(pos, fn))[0]
    np.testing.assert_allclose(n, [0, 1, 0], atol=1e-3)


def test_escape_cone_bound_sound():
    """march_escape_t soundness: every reference distance function obeys
    dist(p) >= (|p| - ESCAPE_RADIUS) / ESCAPE_ALPHA_INV far from the
    origin, so retiring marches past the escape t is result-identical
    (no crossing can exist beyond it)."""
    import numpy as np

    rng = np.random.default_rng(11)
    n = 4096
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = rng.uniform(2.0, 300.0, size=(n, 1))
    pts = jnp.asarray((dirs * radii).astype(np.float32))
    norms = np.linalg.norm(np.asarray(pts), axis=-1)
    lower = (norms - sdf.ESCAPE_RADIUS) / sdf.ESCAPE_ALPHA_INV
    for code in range(7):  # reference primitives only (extensions are
        d = np.asarray(sdf.DISTANCE_FUNCTIONS[code](pts))  # AABB-windowed)
        assert (d >= lower - 1e-3).all(), (
            code, float((d - lower).min()))


# ---------------------------------------------------------------------------
# Over-relaxed sphere tracing (Keinert 2014 — sdf.extension_relax).
# Extension DE fractals march with omega > 1; the overshoot test (disjoint
# consecutive safety spheres) must catch every skipped crossing, so the
# relaxed march finds the same surfaces as the plain one.
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("distance_fn", "relax", "cull_backface")
)
def _trace_relax(o, d, distance_fn, relax, cull_backface=True):
    return sdf.sphere_trace(
        o, d, distance_fn, step_scale=1.0, t_max=TMAX,
        cull_backface=cull_backface, escape_bound=False, relax=relax,
    )


class TestOverRelaxedMarch:
    def test_relaxed_sphere_exact(self):
        # A smooth true SDF: the relaxed march must land on the same
        # surface point as the plain one (crossing acceptance uses the
        # identical threshold once omega turns off near the surface).
        o, d = _ray((0, 0, -5), (0, 0, 1))
        hit, t, n = _trace_relax(o, d, _UNIT_SPHERE, relax=1.6)
        assert bool(hit[0])
        assert float(t[0]) == pytest.approx(4.0, abs=2e-3)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-2)

    def test_relaxed_miss_escapes(self):
        o, d = _ray((0, 5, -5), (0, 0, 1))
        hit, t, _ = _trace_relax(o, d, _UNIT_SPHERE, relax=1.6)
        assert not bool(hit[0])

    def test_relaxed_grazing_rays_no_missed_hits(self):
        # Grazing fan over the unit sphere: the overshoot detector must
        # repair every lane the relaxed step carries past the surface.
        n = 512
        ys = np.linspace(-1.3, 1.3, n, dtype=np.float32)
        o = jnp.asarray(np.stack([np.zeros(n), ys, np.full(n, -5.0)], -1),
                        dtype=jnp.float32)
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32),
                             (n, 3))
        hp, tp, _ = _trace_relax(o, d, _UNIT_SPHERE, relax=1.0)
        hr, tr, _ = _trace_relax(o, d, _UNIT_SPHERE, relax=1.6)
        hp, tp, hr, tr = map(np.asarray, (hp, tp, hr, tr))
        assert (hp == hr).all()
        m = hp
        np.testing.assert_allclose(tr[m], tp[m], atol=5e-3)

    def test_relaxed_matches_plain_on_extension_fractal(self):
        # Mandelbulb DE (code 7, the production user of relaxation): DE
        # fields underestimate distance, so the disjoint-spheres test is
        # conservative; hit sets must agree except at knife-edge
        # threshold crossings.
        from gpuraytracer.geometry.fractal import (
            ExtendedSignedDistancePrimitive,
        )

        code = int(ExtendedSignedDistancePrimitive.MANDELBULB)
        fn = sdf.DISTANCE_FUNCTIONS[code]
        rng = np.random.default_rng(7)
        n = 2048
        o_np = rng.normal(size=(n, 3)).astype(np.float32)
        o_np *= 3.0 / np.linalg.norm(o_np, axis=-1, keepdims=True)
        aim = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
        d_np = aim - o_np
        d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
        o, d = jnp.asarray(o_np), jnp.asarray(d_np)
        hp, tp, _ = _trace_relax(o, d, fn, relax=1.0, cull_backface=False)
        hr, tr, _ = _trace_relax(o, d, fn, relax=1.6, cull_backface=False)
        hp, tp, hr, tr = map(np.asarray, (hp, tp, hr, tr))
        agree = hp == hr
        assert agree.mean() > 0.99, float(agree.mean())
        m = agree & hp
        assert m.any()
        close = np.abs(tr[m] - tp[m]) <= 1e-2
        assert close.mean() > 0.99, float(close.mean())


def test_extension_relax_knob(monkeypatch):
    monkeypatch.delenv("GPURT_RELAX", raising=False)
    assert sdf.extension_relax() == sdf.RELAX_OMEGA
    monkeypatch.setenv("GPURT_RELAX", "1.4")
    assert sdf.extension_relax() == 1.4
    # <= 1 and junk disable relaxation rather than erroring.
    monkeypatch.setenv("GPURT_RELAX", "0.5")
    assert sdf.extension_relax() == 1.0
    monkeypatch.setenv("GPURT_RELAX", "nope")
    assert sdf.extension_relax() == sdf.RELAX_OMEGA


def test_occlusion_relax_knob(monkeypatch):
    # Shadow marches relax by default (accuracy A/B in the docstring);
    # 1.0 restores the exact reference step sequence.
    monkeypatch.delenv("GPURT_RELAX_SHADOW", raising=False)
    assert sdf.occlusion_relax() == 1.6
    assert sdf.relax_for_code(0, occlusion=True) == 1.6
    assert sdf.relax_for_code(0, occlusion=False) == 1.0
    monkeypatch.setenv("GPURT_RELAX_SHADOW", "1.0")
    assert sdf.occlusion_relax() == 1.0
    assert sdf.relax_for_code(0, occlusion=True) == 1.0
    monkeypatch.setenv("GPURT_RELAX_SHADOW", "nope")
    assert sdf.occlusion_relax() == 1.6
    # Extension codes keep their own (larger-or-equal) relaxation.
    monkeypatch.setenv("GPURT_RELAX_SHADOW", "1.2")
    monkeypatch.delenv("GPURT_RELAX", raising=False)
    assert sdf.relax_for_code(7, occlusion=True) == sdf.RELAX_OMEGA


def test_shadow_budget_cap_knob(monkeypatch):
    # Occlusion marches cap at 96 steps by default (round-5 sweep under
    # the capped=>occluded semantics — measured table in the docstring);
    # GPURT_SHADOW_BUDGET=0 restores the full budget.
    monkeypatch.delenv("GPURT_SHADOW_BUDGET", raising=False)
    assert sdf.shadow_budget_cap() == 96
    assert sdf.cap_occlusion_budget(512) == 96
    assert sdf.cap_occlusion_budget(64) == 64
    monkeypatch.setenv("GPURT_SHADOW_BUDGET", "256")
    assert sdf.cap_occlusion_budget(512) == 256
    # <= 1 disables the cap; junk falls back to the default.
    monkeypatch.setenv("GPURT_SHADOW_BUDGET", "0")
    assert sdf.shadow_budget_cap() == 0
    assert sdf.cap_occlusion_budget(512) == 512
    monkeypatch.setenv("GPURT_SHADOW_BUDGET", "1.0")
    assert sdf.shadow_budget_cap() == 0
    monkeypatch.setenv("GPURT_SHADOW_BUDGET", "nope")
    assert sdf.shadow_budget_cap() == 96
    # Radiance marches cap at 160 by default (0.023% of pixels move —
    # round-5 sweep in the docstring); 0 restores the reference 512.
    monkeypatch.delenv("GPURT_MARCH_BUDGET", raising=False)
    assert sdf.radiance_budget_cap() == 160
    assert sdf.cap_radiance_budget(512) == 160
    assert sdf.cap_radiance_budget(128) == 128
    monkeypatch.setenv("GPURT_MARCH_BUDGET", "0")
    assert sdf.radiance_budget_cap() == 0
    assert sdf.cap_radiance_budget(512) == 512


def test_bounce_budget_cap_knobs(monkeypatch):
    # BOUNCE-level (recursion depth >= 1) marches take harsher caps: their
    # error lands scaled by the parent reflection's throughput. Defaults
    # 64 (occlusion) / 128 (radiance) — measured A/B in the docstrings.
    for var in ("GPURT_SHADOW_BUDGET", "GPURT_SHADOW_BUDGET_B",
                "GPURT_MARCH_BUDGET", "GPURT_MARCH_BUDGET_B"):
        monkeypatch.delenv(var, raising=False)
    assert sdf.bounce_shadow_budget_cap() == 64
    assert sdf.cap_occlusion_budget(512, bounce=True) == 64
    assert sdf.cap_occlusion_budget(32, bounce=True) == 32
    # bounce=False is unchanged by the B knob.
    assert sdf.cap_occlusion_budget(512) == 96
    assert sdf.bounce_radiance_budget_cap() == 128
    assert sdf.cap_radiance_budget(512, bounce=True) == 128
    assert sdf.cap_radiance_budget(512) == 160
    # 0 disables: bounce levels inherit the level-less cap.
    monkeypatch.setenv("GPURT_SHADOW_BUDGET_B", "0")
    assert sdf.cap_occlusion_budget(512, bounce=True) == 96
    monkeypatch.setenv("GPURT_MARCH_BUDGET_B", "0")
    assert sdf.cap_radiance_budget(512, bounce=True) == 160
    # Junk falls back to the defaults.
    monkeypatch.setenv("GPURT_SHADOW_BUDGET_B", "nope")
    assert sdf.bounce_shadow_budget_cap() == 64
    monkeypatch.setenv("GPURT_MARCH_BUDGET_B", "nope")
    assert sdf.bounce_radiance_budget_cap() == 128
