"""Entry points on the CPU: the preview server's lifecycle, the refusal of
an explicit GPU on a host without one, and chip_smoke.py's refusals."""

import json
import os
import shutil
import struct
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from gpuraytracer.apps import render_cli, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(pred, timeout=600.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.05)


def _png_size(data):
    return struct.unpack(">II", data[16:24])


@pytest.fixture
def keep_platforms():
    """The apps set jax_platforms from --platform; keep this worker's."""
    import jax

    old = jax.config.jax_platforms
    yield
    jax.config.update("jax_platforms", old)


def test_serve_frames_resize_and_stop(keep_platforms):
    server, state, render = serve.start(32, 18, "cpu", port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        _wait(lambda: state.frames > 0 or state.error)
        assert not state.error
        status, data = _get(base + "/frame.png")
        assert status == 200 and data[:4] == b"\x89PNG"
        assert _png_size(data) == (32, 18)
        assert _get(base + "/resize?w=4&h=4")[0] == 400  # out of bounds
        assert _get(base + "/resize?w=24&h=16")[0] == 200

        def resized():
            with state.lock:
                return _png_size(state.png_bytes) == (24, 16)

        _wait(resized)
        status, stats = _get(base + "/stats")
        assert status == 200 and b"platform cpu" in stats
    finally:
        server.shutdown()
        server.server_close()
        state.stop.set()
        render.join(timeout=120)
    assert not render.is_alive()


def test_serve_reports_render_failure(keep_platforms):
    # An explicit GPU on this CPU-only host: the render thread fails, and
    # clients get the error instead of waiting on a frame forever.
    server, state, render = serve.start(32, 18, "gpu", port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        render.join(timeout=120)
        status, body = _get(base + "/frame.png")
        assert status == 500 and b"no usable device" in body
    finally:
        server.shutdown()
        server.server_close()
        state.stop.set()


def test_render_cli_explicit_gpu_without_one_fails(tmp_path, keep_platforms):
    with pytest.raises(RuntimeError, match="platform='gpu'"):
        render_cli.main(["--width", "16", "--height", "8", "--platform",
                         "gpu", "--out", str(tmp_path)])


@pytest.mark.parametrize("lone", [False, True], ids=["checkout", "lone_file"])
def test_chip_smoke_refuses_without_gpu(tmp_path, lone):
    """No GPU (this host) -> exit 1; outside a checkout -> exit 2. Either
    way no JSON result is printed."""
    script = os.path.join(REPO, "chip_smoke.py")
    if lone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == (2 if lone else 1), proc.stderr
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
