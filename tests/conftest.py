"""Test harness configuration.

Tests run on the CPU backend (the WARP-software-device analog,
SURVEY.md §4) with 8 virtual devices so multi-device sharding paths are
exercised without GPUs. A persistent compilation cache keeps the
expensive full-scene closest-hit compiles amortized across test runs.
Tests marked `gpu` need the card and skip here.
"""

import os
import shutil

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Also set through the config, in case a plugin imported jax before the
# variable above was set (backends are lazy, so this still wins).
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from gpuraytracer.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


@pytest.fixture(scope="session")
def builtin_scene():
    from gpuraytracer.models import builtin

    return builtin.build_scene(aspect=1.0, elapsed_time=0.0)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture
def card():
    """Skips unless this host has an NVIDIA card; returns the environment
    for a child process that uses it. Decided here, in a fixture, never at
    import time; the card is used from a child, since this process is held
    to the CPU."""
    if shutil.which("nvidia-smi") is None or not os.path.exists("/dev/nvidia0"):
        pytest.skip("needs an NVIDIA GPU")
    return dict(os.environ, JAX_PLATFORMS="cuda")
