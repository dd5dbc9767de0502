"""Utils + native runtime tests: PNG, timers, stats."""

import io
import os

import numpy as np
import pytest

from gpuraytracer.runtime import hostrt
from gpuraytracer.utils import png as png_mod
from gpuraytracer.utils.stats import (
    FrameStats,
    mrays_per_second_from_dispatch_ms,
    mrays_per_second_from_fps,
)
from gpuraytracer.utils.timers import EmaTimer, StepTimer


def _rand_image(h=17, w=23, c=4):
    return (np.random.default_rng(7).random((h, w, c)) * 255).astype(np.uint8)


class TestPng:
    def test_pure_python_roundtrip(self, tmp_path):
        img = _rand_image()
        data = png_mod.encode_png(img)
        from PIL import Image

        back = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(back, img)

    def test_rgb_roundtrip(self, tmp_path):
        img = _rand_image(c=3)
        data = png_mod.encode_png(img)
        from PIL import Image

        back = np.asarray(Image.open(io.BytesIO(data)))
        np.testing.assert_array_equal(back, img)

    def test_native_writer_roundtrip(self, tmp_path):
        if not hostrt.available():
            pytest.skip("native hostrt not built")
        img = _rand_image()
        path = str(tmp_path / "native.png")
        hostrt.write_png(path, img)
        from PIL import Image

        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back, img)

    def test_async_writer(self, tmp_path):
        img = _rand_image()
        paths = [str(tmp_path / f"f{i}.png") for i in range(6)]
        with hostrt.AsyncFrameWriter(2) as w:
            for p in paths:
                w.submit(p, img)
            w.drain()
        for p in paths:
            assert os.path.exists(p)

    def test_image_f32_conversion(self):
        f = np.asarray([[[-0.5, 0.5, 1.5, 0.2]]], dtype=np.float32)
        q = png_mod.image_f32_to_rgba8(f)
        np.testing.assert_array_equal(q, [[[0, 128, 255, 255]]])


class TestTimers:
    def test_step_timer_variable(self):
        now = [0.0]
        t = StepTimer(clock=lambda: now[0])
        now[0] = 0.016
        t.tick()
        assert t.elapsed_seconds == pytest.approx(0.016)
        assert t.frame_count == 1

    def test_step_timer_clamps_huge_delta(self):
        now = [0.0]
        t = StepTimer(clock=lambda: now[0])
        now[0] = 5.0  # breakpoint pause
        t.tick()
        assert t.elapsed_seconds == pytest.approx(0.1)

    def test_fixed_step_accumulates(self):
        now = [0.0]
        t = StepTimer(clock=lambda: now[0], fixed_time_step=True,
                      target_delta_seconds=0.01)
        updates = []
        now[0] = 0.035
        t.tick(updates.append)
        assert len(updates) == 3  # 0.035 -> 3 full steps, 0.005 leftover
        assert t.frame_count == 3
        now[0] = 0.041
        t.tick(updates.append)
        assert len(updates) == 4

    def test_ema_timer(self):
        now = [0.0]
        t = EmaTimer(clock=lambda: now[0])
        t.start(); now[0] = 0.010; t.stop()
        assert t.average_ms == pytest.approx(10.0)
        t.start(); now[0] = 0.030; t.stop()
        # avg = 0.95*10 + 0.05*20 = 10.5
        assert t.average_ms == pytest.approx(10.5)

    def test_native_clock_monotonic(self):
        a = hostrt.now_seconds()
        b = hostrt.now_seconds()
        assert b >= a


class TestStats:
    def test_mrays_formulas(self):
        # Renderer.cpp:391: W*H*fps/1e6; helper: W*H/(ms*1e3).
        assert mrays_per_second_from_fps(1280, 720, 60.0) == pytest.approx(55.296)
        assert mrays_per_second_from_dispatch_ms(1280, 720, 10.0) == pytest.approx(92.16)

    def test_frame_stats_window(self):
        now = [0.0]
        snaps = []
        s = FrameStats(100, 100, on_update=snaps.append, clock=lambda: now[0])
        for i in range(10):
            now[0] += 0.2
            s.frame_rendered()
        assert len(snaps) >= 1
        assert snaps[0].fps == pytest.approx(5.0, rel=0.01)
        assert snaps[0].mrays_per_second == pytest.approx(0.05, rel=0.01)
        assert "fps" in s.status_line("dev")


class TestEvent:
    def test_attach_dispatch_detach(self):
        from gpuraytracer.utils.event import Event

        ev = Event()
        seen = []
        fn = seen.append
        ev.attach(fn)
        ev(1)
        ev.detach(fn)
        ev(2)
        assert seen == [1]

    def test_weak_method_autocleanup(self):
        from gpuraytracer.utils.event import Event

        class Listener:
            def __init__(self):
                self.seen = []

            def on_evt(self, v):
                self.seen.append(v)

        ev = Event()
        l = Listener()
        ev.attach(l.on_evt)
        ev("a")
        assert l.seen == ["a"]
        del l
        import gc

        gc.collect()
        ev("b")  # dead listener dropped, no error
        assert ev.listener_count == 0

    def test_viewport_resize_event(self):
        from gpuraytracer.utils.event import Viewport

        vp = Viewport(640, 360)
        sizes = []
        vp.on_size_changed.attach(lambda w, h: sizes.append((w, h)))
        vp.resize(640, 360)  # no-op resize ignored (reference behavior)
        vp.resize(1280, 720)
        assert sizes == [(1280, 720)]
        assert vp.aspect_ratio == pytest.approx(16 / 9)


class TestCompileCache:
    def test_default_dir_is_fixed_in_checkout(self, monkeypatch):
        import jax

        from gpuraytracer.utils import compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.setup_compile_cache()
        assert path == os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.exists(os.path.join(compile_cache.CHECKOUT, "gpuraytracer"))

    def test_env_dir_is_left_alone(self, tmp_path):
        import subprocess
        import sys

        src = (
            "import jax\n"
            "from gpuraytracer.utils.compile_cache import setup_compile_cache\n"
            "print(setup_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n"
        )
        env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            [sys.executable, "-c", src], env=env, cwd=repo,
            capture_output=True, text=True, check=True, timeout=120,
        ).stdout.split()
        assert out == [str(tmp_path), str(tmp_path)]
