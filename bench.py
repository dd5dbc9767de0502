"""Benchmark harness — the calculate_frame_stats / GPUTimer analog.

Headline metric (BASELINE.md): "~Million Primary Rays/s" = W*H*fps / 1e6
(reference: Renderer.cpp:374-399) on the 1080p builtin scene (the SDF
fractal is the dominant cost — BASELINE.json configs #3/#5 class).

Needs a GPU: exits non-zero, printing no result, when JAX finds none.
Prints ONE JSON line: {"metric", "value", "unit", "detail"}, with the
device's platform, kind and count in "detail".
"""

from __future__ import annotations

import json
import sys
import time


def run_bench(width: int = 1920, height: int = 1080, frames: int = 64, warmup: int = 2,
              chain: int = 64):
    import jax

    from gpuraytracer.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from gpuraytracer.models import builtin
    from gpuraytracer.render import trace

    import jax.numpy as jnp

    from gpuraytracer.accel.instances import Scene

    scene0 = builtin.build_scene(aspect=width / height, elapsed_time=0.0)
    layout = scene0.layout

    @jax.jit
    def render(arrays, t_start):
        # A burst of `chain` animated frames per dispatch, like the
        # reference's default run (geometry animation on): each frame's
        # transform rebuild (the on_update work) runs inside the same
        # program as its trace, at its own elapsed_time, via lax.scan —
        # ONE compile of the frame program regardless of chain length.
        def frame(carry, t):
            acc, _ = carry
            arrays_i = builtin.animate_arrays(arrays, t)
            img = trace.render_frame(Scene(layout, arrays_i), width, height)
            # The frame rides the scan carry (the reference's per-frame UAV
            # write analog); the scalar checksum is what the host fetches.
            return (acc + jnp.sum(img), img), None

        ts = t_start + 0.0333 * jnp.arange(chain, dtype=jnp.float32)
        fb0 = jnp.zeros((height, width, 4), dtype=jnp.float32)
        (acc, _last), _ = jax.lax.scan(frame, (jnp.float32(0.0), fb0), ts)
        return acc

    arrays0 = scene0.arrays
    for i in range(warmup):
        float(render(arrays0, 0.0333 * chain * i))

    # Steady-state throughput with windows in flight — the reference's own
    # fps semantics (triple-buffered swapchain, fps averaged over a 1 s
    # window: Renderer.cpp:374-399 + fence pacing): windows dispatch
    # asynchronously and the wall clock covers all rendered frames.
    windows = max(1, frames // chain)
    t0 = time.perf_counter()
    checksums = [render(arrays0, 0.0333 * chain * i) for i in range(windows)]
    jax.block_until_ready(checksums)
    wall = time.perf_counter() - t0

    frame_ms = wall / (windows * chain) * 1e3
    fps = 1e3 / frame_ms
    mrays = width * height * fps / 1e6
    dev = jax.devices()[0]
    return {
        "metric": "primary_mrays_per_sec_per_chip_1080p_builtin_scene",
        "value": mrays,
        "unit": "Mrays/s",
        "detail": {
            "frame_ms": frame_ms,
            "fps": fps,
            "width": width,
            "height": height,
            "frames": windows * chain,
            "chain": chain,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }


def main():
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--chain", type=int, default=64,
                   help="animated frames per dispatch window, scanned in"
                        " one program")
    args = p.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()[0]}",
              file=sys.stderr)
        return 1
    result = run_bench(args.width, args.height, args.frames, args.warmup,
                       args.chain)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
