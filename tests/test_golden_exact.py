"""Exact-reference-semantics golden (VERDICT r3 item 5).

The accuracy knobs (march budgets, shadow over-relaxation) default to
measured approximations; the claim "setting them to 0/1.0 restores the
reference's exact step sequence" (SignedDistancePrimitives.hlsli:291-317,
Raytracing.hlsl:115-147) must itself be pinned by an image test, so the
accuracy-trade drift has a FIXED anchor: every future cap change is
measured against THIS golden, not the previous round's re-goldened
approximation.

Knobs bake at trace time (module-level env reads), so the render runs in a
subprocess with the exact-knob environment.
"""

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(HERE, "golden_builtin_exact_96x54_t0p7.npz")
W, H = 96, 54

EXACT_ENV = {
    "GPURT_RELAX_SHADOW": "1.0",
    "GPURT_RELAX_REF": "1.0",
    "GPURT_SHADOW_BUDGET": "0",
    "GPURT_SHADOW_BUDGET_B": "0",
    "GPURT_MARCH_BUDGET": "0",
    "GPURT_MARCH_BUDGET_B": "0",
}

_RENDER_SRC = """
import os
import numpy as np
from gpuraytracer.utils.compile_cache import setup_compile_cache
setup_compile_cache()
from gpuraytracer.models import builtin
from gpuraytracer.render import trace
W, H = 96, 54
scene = builtin.build_scene(aspect=W/H, elapsed_time=0.7)
img = np.asarray(trace.make_renderer(scene.layout, W, H)(scene.arrays))
np.save(os.environ["GPURT_TEST_OUT"], img.astype(np.float32))
"""


def test_exact_knobs_match_exact_golden(tmp_path):
    assert os.path.exists(GOLDEN_PATH), "exact golden missing"
    out = str(tmp_path / "exact.npy")
    env = dict(os.environ)
    env.update(EXACT_ENV)
    env["JAX_PLATFORMS"] = "cpu"
    env["GPURT_TEST_OUT"] = out
    proc = subprocess.run(
        [sys.executable, "-c", _RENDER_SRC],
        env=env, capture_output=True, text=True, timeout=1800,
        cwd=os.path.join(HERE, ".."),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    img = np.load(out)
    golden = np.load(GOLDEN_PATH)["image"]
    assert img.shape == golden.shape
    diff = np.abs(img - golden).max(axis=-1)
    # Same backend, same code, exact step sequence: tight agreement.
    assert diff.max() < 1e-3, f"max diff {diff.max()}"
    assert diff.mean() < 1e-5, f"mean diff {diff.mean()}"


def test_exact_golden_has_scene_content():
    golden = np.load(GOLDEN_PATH)["image"]
    bg = np.asarray([0.8, 0.9, 1.0, 1.0], dtype=np.float32)
    assert (np.abs(golden - bg).max(axis=-1) > 1e-3).mean() > 0.3
