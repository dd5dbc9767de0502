"""Multi-chip correctness: tiled render equals single-chip render
(SURVEY.md §4: "Multi-chip correctness = tile render equals single-chip
render bitwise")."""

import jax
import numpy as np
import pytest

from gpuraytracer.models import builtin
from gpuraytracer.parallel import device as device_mod
from gpuraytracer.parallel import pipeline, sharding
from gpuraytracer.render import trace

W, H = 64, 32


@pytest.fixture(scope="module")
def scene():
    return builtin.build_scene(aspect=W / H, elapsed_time=0.3)


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_equals_single(scene):
    mesh = sharding.make_mesh()
    sharded = sharding.make_sharded_renderer(scene.layout, W, H, mesh)
    img_sharded = sharding.gather_image(sharded(scene.arrays))

    single = trace.make_renderer(scene.layout, W, H)
    img_single = np.asarray(single(scene.arrays))

    # Not bitwise: XLA compiles the (H/8, W) and (H, W) programs separately
    # and may vectorize/reassociate float chains differently; a 1-ulp
    # difference near the sphere-trace 1e-4*t threshold shifts the crossing
    # step slightly. Budget is the 1e-3 per-pixel radiance tolerance.
    np.testing.assert_allclose(img_sharded, img_single, atol=1e-3)
    # And the overwhelming majority of pixels must agree exactly.
    exact = (img_sharded == img_single).all(axis=-1).mean()
    assert exact > 0.8


def test_sharded_stats_psum(scene):
    mesh = sharding.make_mesh()
    sharded = sharding.make_sharded_renderer(
        scene.layout, W, H, mesh, compute_stats=True
    )
    img, mean_radiance = sharded(scene.arrays)
    img = sharding.gather_image(img)
    expected = img[..., :3].mean()
    assert float(mean_radiance) == pytest.approx(float(expected), rel=1e-5)


def test_height_must_divide():
    mesh = sharding.make_mesh()
    with pytest.raises(ValueError):
        sharding.make_sharded_renderer(builtin.LAYOUT, W, 30, mesh)


def test_device_pick_cpu_software_fallback():
    info = device_mod.pick_device("cpu")
    assert info.platform == "cpu"
    assert info.is_software


def test_device_auto_prefers_gpu(monkeypatch):
    class FakeGpu:
        id = 0
        device_kind = "NVIDIA H100 80GB HBM3"

    real = jax.devices

    def devices(name=None):
        return [FakeGpu()] if name == "gpu" else real(name)

    monkeypatch.setattr(jax, "devices", devices)
    info = device_mod.pick_device("auto")
    assert info.platform == "gpu"
    assert not info.is_software
    assert "H100" in info.description


def test_device_auto_falls_back_to_cpu():
    # This host has no GPU: "auto" lands on the software device.
    assert device_mod.available_platforms() == ["cpu"]
    assert device_mod.pick_device("auto").is_software


def test_device_explicit_gpu_without_one_raises():
    with pytest.raises(RuntimeError, match="platform='gpu'"):
        device_mod.pick_device("gpu")


def test_frame_pipeline_bounds_depth():
    import jax.numpy as jnp

    calls = []

    def render(i):
        calls.append(i)
        return jnp.asarray([i])

    pipe = pipeline.FramePipeline(render, frames_in_flight=2)
    completed = []
    for i in range(5):
        _, done = pipe.submit(i)
        if done is not None:
            completed.append(int(done[0]))
    assert completed == [0, 1, 2]
    rest = pipe.drain()
    assert [int(r[0]) for r in rest] == [3, 4]
    assert pipe.in_flight == 0
