"""HLSL-semantics math layer unit tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuraytracer.core import hlsl


def test_fmod_sign_follows_dividend():
    # HLSL fmod(-3.5, 2) == -1.5 (python % would give +0.5). Load-bearing for
    # opRep domain repetition.
    assert float(hlsl.fmod(jnp.float32(-3.5), 2.0)) == pytest.approx(-1.5)
    assert float(hlsl.fmod(jnp.float32(3.5), 2.0)) == pytest.approx(1.5)
    assert float(hlsl.fmod(jnp.float32(-3.5), -2.0)) == pytest.approx(-1.5)


def test_saturate_lerp_frac():
    assert float(hlsl.saturate(jnp.float32(1.5))) == 1.0
    assert float(hlsl.saturate(jnp.float32(-0.5))) == 0.0
    assert float(hlsl.lerp(jnp.float32(2.0), 6.0, 0.25)) == pytest.approx(3.0)
    assert float(hlsl.frac(jnp.float32(-0.25))) == pytest.approx(0.75)


def test_smoothstep_endpoints_and_midpoint():
    assert float(hlsl.smoothstep(0.0, 1.0, jnp.float32(0.0))) == 0.0
    assert float(hlsl.smoothstep(0.0, 1.0, jnp.float32(1.0))) == 1.0
    assert float(hlsl.smoothstep(0.0, 1.0, jnp.float32(0.5))) == pytest.approx(0.5)


def test_reflect_unit_preserving():
    i = jnp.asarray([[0.0, -1.0, 0.0]], dtype=jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], dtype=jnp.float32)
    r = hlsl.reflect(i, n)
    np.testing.assert_allclose(np.asarray(r), [[0.0, 1.0, 0.0]], atol=1e-7)
    # 45 degree bounce
    i = hlsl.normalize(jnp.asarray([[1.0, -1.0, 0.0]], dtype=jnp.float32))
    r = hlsl.reflect(i, n)
    np.testing.assert_allclose(
        np.asarray(hlsl.length(r)), [1.0], atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(r[0, 1]), np.asarray(-i[0, 1]), atol=1e-6)


def test_animation_interpolant_cycle():
    # 0 at cycle start, 1 at half cycle, 0 at full cycle; smooth triangle.
    f = lambda t: float(hlsl.calculate_animation_interpolant(jnp.float32(t), 12.0))
    assert f(0.0) == pytest.approx(0.0)
    assert f(6.0) == pytest.approx(1.0)
    assert f(12.0) == pytest.approx(0.0, abs=1e-6)
    assert f(3.0) == pytest.approx(0.5)
    assert f(9.0) == pytest.approx(0.5)
    # Smoothstepped: quarter-cycle value is smoothstep(0.5) == 0.5 exactly;
    # eighth-cycle is smoothstep(0.25) = 0.15625.
    assert f(1.5) == pytest.approx(0.15625, abs=1e-6)


def test_normalize_and_length():
    v = jnp.asarray([[3.0, 4.0, 0.0]], dtype=jnp.float32)
    assert float(hlsl.length(v)[0]) == pytest.approx(5.0)
    np.testing.assert_allclose(
        np.asarray(hlsl.normalize(v)), [[0.6, 0.8, 0.0]], atol=1e-6
    )
