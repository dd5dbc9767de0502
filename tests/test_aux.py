"""Aux subsystem tests: checkpoint/resume, debug layer, recovery, scenes,
registry, config."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpuraytracer.core.config import RenderConfig
from gpuraytracer.core.types import IntersectorKind
from gpuraytracer.geometry import registry
from gpuraytracer.geometry.fractal import (
    ExtendedSignedDistancePrimitive,
    distance_julia_quaternion,
    distance_mandelbulb,
)
from gpuraytracer.models import scenes
from gpuraytracer.models.animate import AnimationState
from gpuraytracer.parallel.recovery import DeviceLostError, RecoveringExecutor
from gpuraytracer.utils import checkpoint, debug


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        cfg = RenderConfig(width=320, height=180, animate_camera=True)
        state = AnimationState.initial()
        state = state.tick(0.5, cfg)
        path = str(tmp_path / "ckpt.json")
        checkpoint.save(path, state, cfg, frame_index=42)
        state2, cfg2, idx = checkpoint.load(path)
        assert idx == 42
        assert cfg2 == cfg
        assert state2.geometry_time == pytest.approx(state.geometry_time)
        np.testing.assert_allclose(state2.camera.eye, state.camera.eye)
        np.testing.assert_allclose(state2.light_position, state.light_position)

    def test_resume_continues_animation(self, tmp_path):
        cfg = RenderConfig()
        state = AnimationState.initial().tick(1.0, cfg)
        path = str(tmp_path / "c.json")
        checkpoint.save(path, state, cfg)
        resumed, _, _ = checkpoint.load(path)
        a = state.tick(0.5, cfg)
        b = resumed.tick(0.5, cfg)
        assert a.geometry_time == pytest.approx(b.geometry_time)


class TestDebug:
    def test_validate_frame_ok(self):
        debug.validate_frame(jnp.ones((4, 4, 4)))

    def test_validate_frame_rejects_nan(self):
        img = jnp.ones((4, 4, 4)).at[0, 0, 0].set(jnp.nan)
        with pytest.raises(AssertionError):
            debug.validate_frame(img)

    def test_validate_frame_rejects_shape(self):
        with pytest.raises(AssertionError):
            debug.validate_frame(jnp.ones((4, 4, 3)))

    def test_checked_passes_clean_fn(self):
        f = debug.checked(lambda x: x * 2.0)
        assert float(f(jnp.float32(2.0))) == 4.0

    def test_debug_layer_context(self):
        with debug.debug_layer(nan_checks=True):
            assert jax.config.jax_debug_nans
        assert not jax.config.jax_debug_nans


class TestRecovery:
    def test_passthrough(self):
        ex = RecoveringExecutor(lambda: (lambda x: x + 1))
        assert float(ex(jnp.float32(1.0))) == 2.0
        assert ex.recoveries == 0

    def test_recovers_then_raises(self):
        builds = []

        def make_step():
            builds.append(1)
            n = len(builds)

            def step(x):
                if n < 3:
                    raise jax.errors.JaxRuntimeError("injected device fault")
                return x * 10

            return step

        ex = RecoveringExecutor(make_step, max_retries=3, retry_delay_seconds=0.0)
        out = ex(jnp.float32(2.0))
        assert float(out) == 20.0
        assert ex.recoveries == 2

    def test_gives_up(self):
        def make_step():
            def step(x):
                raise jax.errors.JaxRuntimeError("permanent fault")

            return step

        ex = RecoveringExecutor(make_step, max_retries=1, retry_delay_seconds=0.0)
        with pytest.raises(DeviceLostError):
            ex(jnp.float32(1.0))

    def test_recovers_plugin_runtime_error(self):
        # PJRT plugins raise bare RuntimeError for driver faults — must
        # recover like a device loss.
        builds = []

        def make_step():
            builds.append(1)
            n = len(builds)

            def step(x):
                if n < 2:
                    raise RuntimeError("driver reset (injected)")
                return x * 3

            return step

        ex = RecoveringExecutor(make_step, max_retries=2, retry_delay_seconds=0.0)
        assert float(ex(jnp.float32(2.0))) == 6.0
        assert ex.recoveries == 1

    def test_recovers_connection_error(self):
        builds = []

        def make_step():
            builds.append(1)
            n = len(builds)

            def step(x):
                if n < 2:
                    raise ConnectionResetError("transport reset (injected)")
                return x + 5

            return step

        ex = RecoveringExecutor(make_step, max_retries=2, retry_delay_seconds=0.0)
        assert float(ex(jnp.float32(1.0))) == 6.0
        assert ex.recoveries == 1

    def test_programming_bugs_stay_fatal(self):
        def make_step():
            def step(x):
                raise ValueError("shape mismatch (a bug, not device loss)")

            return step

        ex = RecoveringExecutor(make_step, max_retries=3, retry_delay_seconds=0.0)
        with pytest.raises(ValueError):
            ex(jnp.float32(1.0))
        assert ex.recoveries == 0

    def test_watchdog_times_out_wedged_step(self):
        # A wedged device: the step blocks forever at ~0% CPU.
        import threading

        builds = []
        release = threading.Event()

        def make_step():
            builds.append(1)
            n = len(builds)

            def step(x):
                if n < 2:
                    release.wait(timeout=30.0)  # wedge (until abandoned)
                return x * 7

            return step

        ex = RecoveringExecutor(
            make_step, max_retries=2, retry_delay_seconds=0.0,
            watchdog_seconds=0.2,
        )
        try:
            assert float(ex(jnp.float32(1.0))) == 7.0
            assert ex.recoveries == 1
        finally:
            release.set()  # let the abandoned worker exit


class TestExtendedFractals:
    def test_mandelbulb_signs(self):
        p = jnp.asarray([[0.0, 0.0, 0.0], [2.0, 2.0, 2.0]], dtype=jnp.float32)
        d = np.asarray(distance_mandelbulb(p))
        assert d[0] < 0.0  # origin is inside the bulb
        assert d[1] > 0.0

    def test_julia_signs(self):
        p = jnp.asarray([[0.0, 0.0, 0.0], [2.0, 2.0, 2.0]], dtype=jnp.float32)
        d = np.asarray(distance_julia_quaternion(p))
        assert d[1] > 0.0
        assert abs(d[0]) < 1.0  # near the set

    def test_registered_in_registry(self):
        keys = registry.registered()
        assert (IntersectorKind.SIGNED_DISTANCE, int(ExtendedSignedDistancePrimitive.MANDELBULB)) in keys
        assert (IntersectorKind.SIGNED_DISTANCE, int(ExtendedSignedDistancePrimitive.JULIA_QUATERNION)) in keys


class TestScenes:
    @pytest.mark.parametrize("cfg", scenes.BENCH_CONFIGS, ids=lambda c: c.name)
    def test_configs_build(self, cfg):
        scene = cfg.build(cfg.width / cfg.height, 0.0)
        assert scene.layout.num_procedural >= 1
        assert scene.arrays.aabb_min.shape[0] == scene.layout.num_procedural

    def test_config_lookup(self):
        assert scenes.get_config("metaballs_1080p").animated
        with pytest.raises(KeyError):
            scenes.get_config("nope")


class TestRegistryDispatch:
    def test_static_and_dynamic_agree(self):
        o = jnp.asarray([[0.0, 0.0, -5.0]], dtype=jnp.float32)
        d = jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32)
        kw = dict(t_min=0.0, t_max=1e4, cull_backface=True,
                  step_scale=jnp.float32(1.0), elapsed_time=jnp.float32(0.0),
                  active=jnp.asarray([True]))
        from gpuraytracer.core.types import AnalyticPrimitive

        fn = registry.lookup(IntersectorKind.ANALYTIC, AnalyticPrimitive.SPHERES)
        hit_s, t_s, _ = fn(o, d, **kw)
        code = registry.dense_code(IntersectorKind.ANALYTIC, AnalyticPrimitive.SPHERES)
        hit_d, t_d, _ = jax.jit(
            lambda c: registry.intersect_switch(c, o, d, **kw)
        )(code)
        assert bool(hit_s[0]) == bool(hit_d[0])
        np.testing.assert_allclose(np.asarray(t_s), np.asarray(t_d), atol=1e-6)


class TestIntrospect:
    def test_describe_scene(self, builtin_scene):
        from gpuraytracer.utils import introspect

        text = introspect.describe_scene(builtin_scene)
        assert "10 procedural geometries + ground plane" in text
        assert "FRACTAL_PYRAMID" in text
        assert "METABALLS" in text
        assert "GROUND_PLANE" in text
        assert text.count("\n") >= 12

    def test_describe_backend(self):
        from gpuraytracer.utils import introspect

        s = introspect.describe_backend()
        assert "traversal=" in s
