"""Generate small-resolution CPU golden images for the five BASELINE
configs (SURVEY.md §4 test strategy; VERDICT round-1 item 5).

Renders each config on the CPU backend (the WARP-software-device analog)
at a fixed tiny resolution and animation time, and saves
tests/golden_<name>.npz. tests/test_golden_suite.py pins future renders
against these exactly.

Usage: python tools/make_goldens.py [--force]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

GOLDEN_W, GOLDEN_H = 96, 54
GOLDEN_T = 0.7


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    cache = os.path.join(os.path.dirname(__file__), "..", ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", os.path.abspath(cache))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    import numpy as np

    from gpuraytracer.models.scenes import BENCH_CONFIGS
    from gpuraytracer.render import trace

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    for cfg in BENCH_CONFIGS:
        path = os.path.abspath(
            os.path.join(out_dir, f"golden_{cfg.name}_{GOLDEN_W}x{GOLDEN_H}_t0p7.npz")
        )
        if os.path.exists(path) and not args.force:
            print(f"exists: {path}")
            continue
        scene = cfg.build(GOLDEN_W / GOLDEN_H, GOLDEN_T)
        img = np.asarray(
            trace.render_frame(scene, GOLDEN_W, GOLDEN_H, max_depth=cfg.max_depth)
        )
        assert np.isfinite(img).all(), cfg.name
        np.savez_compressed(
            path, image=img.astype(np.float32),
            width=GOLDEN_W, height=GOLDEN_H, t=GOLDEN_T, max_depth=cfg.max_depth,
        )
        print(f"wrote {path}  mean={img.mean():.4f}")


if __name__ == "__main__":
    main()
