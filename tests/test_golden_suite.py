"""Golden-image tests for the five BASELINE.json bench configs.

Each config renders at 96x54 on the CPU backend (the WARP analog) and must
match its committed golden exactly (CPU XLA is deterministic; parity-exact
optimizations by definition leave these untouched). Regenerate with
tools/make_goldens.py --force ONLY for intentional behavior changes.
"""

import os

import numpy as np
import pytest

from gpuraytracer.models.scenes import BENCH_CONFIGS
from gpuraytracer.render import trace

GOLDEN_W, GOLDEN_H = 96, 54
GOLDEN_T = 0.7
_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("cfg", BENCH_CONFIGS, ids=[c.name for c in BENCH_CONFIGS])
def test_config_matches_golden(cfg):
    path = os.path.join(_DIR, f"golden_{cfg.name}_{GOLDEN_W}x{GOLDEN_H}_t0p7.npz")
    if not os.path.exists(path):
        pytest.fail(f"missing golden {path}; run tools/make_goldens.py")
    data = np.load(path)
    assert int(data["max_depth"]) == cfg.max_depth

    scene = cfg.build(GOLDEN_W / GOLDEN_H, GOLDEN_T)
    img = np.asarray(
        trace.render_frame(scene, GOLDEN_W, GOLDEN_H, max_depth=cfg.max_depth)
    )
    assert np.isfinite(img).all()
    ref = data["image"]
    # Tight float tolerance: same backend, same program — any drift means a
    # real behavior change (the BASELINE accuracy bar is 1e-3; hold CI two
    # orders tighter).
    np.testing.assert_allclose(img, ref, atol=1e-5, rtol=0)
