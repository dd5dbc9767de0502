"""Benchmark suite over the five BASELINE.json configs.

Records both Mrays/s variants the reference computes — fps-derived
(Renderer.cpp:391) and dispatch-time-derived
(RendererRaytracingHelper.h:673-678):

- WALL throughput: windows of `--wall-chain` chained animated frames,
  dispatched in flight (the bench.py headline methodology; the
  reference's triple-buffered fence pacing amortizes Present latency the
  same way — DeviceResources.cpp:770-792, and its published fps window
  is a full second of frames, Renderer.cpp:374-399). Median over `--reps`
  reps. The single-dispatch-per-frame wall is kept as
  `frame_ms_1dispatch`.
- DEVICE frame time: the SLOPE between a 1-frame and an N-frame chained
  program (N sequential data-dependent frames inside ONE dispatch), which
  cancels the per-dispatch host cost — the GPU-timestamp-derived
  variant's analog (PerformanceTimers.cpp:139-171).

Needs a GPU: exits non-zero when JAX finds none.

Usage:
  python -m gpuraytracer.apps.bench_suite [--configs a,b] [--frames 4]
         [--reps 3] [--chain 3] [--scale 1.0] [--no-device-time]
         [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _timed_window(fn, args, frames: int):
    """One frames-in-flight window: submit async, sync once; ms/frame."""
    t0 = time.perf_counter()
    outs = [fn(*a) for a in args[:frames]]
    for o in outs:
        float(o)
    return (time.perf_counter() - t0) / frames * 1e3


def bench_config(cfg, frames: int = 4, warmup: int = 1, scale: float = 1.0,
                 reps: int = 3, chain: int = 3, device_time: bool = True,
                 wall_chain: int = 64):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuraytracer.accel.instances import Scene
    from gpuraytracer.render import trace
    from gpuraytracer.utils import stats

    width = max(8, int(cfg.width * scale))
    height = max(8, int(cfg.height * scale))
    builder = cfg.builder()
    scene0 = builder.build(width / height, 0.0)
    layout = scene0.layout
    animate = builder.animator()

    def frame_t(i):
        # Non-animated configs still get a microscopic time perturbation so
        # chained frames cannot be CSE'd into one render by XLA.
        return 0.033 * i if cfg.animated else 1e-5 * i

    import dataclasses

    def make_chain(n):
        @jax.jit
        def chain(arrays):
            acc = jnp.float32(0.0)
            for i in range(n):
                a = animate(arrays, frame_t(i))
                # Configs whose animator consumes no time (static single
                # sphere) would still CSE the chained frames; a 1e-6
                # camera perturbation makes every frame a distinct
                # program at unmeasurable render cost.
                ci = dataclasses.replace(
                    a.constants,
                    camera_position=a.constants.camera_position
                    + jnp.float32(1e-6) * i,
                )
                a = dataclasses.replace(a, constants=ci)
                img = trace.render_frame(
                    Scene(layout, a), width, height, max_depth=cfg.max_depth
                )
                # Checksum forces materialization without a framebuffer
                # transfer.
                acc = acc + jnp.sum(img)
            return acc
        return chain

    step = make_chain(1)
    arrays0 = scene0.arrays
    t0 = time.perf_counter()
    float(step(arrays0))
    t_compile = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        float(step(arrays0))

    # Wall throughput: `frames` windows of `wall_chain` chained animated
    # frames each, dispatched in flight (exactly bench.py's headline
    # methodology). Frames inside a window are distinct programs (each
    # animates at its own elapsed_time), so the device renders
    # frames*wall_chain real frames per rep.
    window_args = [(arrays0,)] * frames
    wall_fn = make_chain(wall_chain) if wall_chain > 1 else step
    if wall_chain > 1:
        float(wall_fn(arrays0))  # compile
    wall_ms = [
        _timed_window(wall_fn, window_args, frames) / wall_chain
        for _ in range(reps)
    ]
    frame_ms = float(np.median(wall_ms))
    fps = 1e3 / frame_ms
    # The per-dispatch wall (1 frame per dispatch window), which includes
    # the host's per-dispatch cost.
    ms_1dispatch = min(
        _timed_window(step, window_args, frames) for _ in range(reps)
    )

    out = {
        "config": cfg.name,
        "width": width,
        "height": height,
        "max_depth": cfg.max_depth,
        "frame_ms": round(frame_ms, 3),
        "frame_ms_min": round(min(wall_ms), 3),
        "frame_ms_max": round(max(wall_ms), 3),
        "reps": reps,
        "frames_per_window": frames,
        "wall_chain": wall_chain,
        "frame_ms_1dispatch": round(ms_1dispatch, 3),
        "fps": round(fps, 3),
        "mrays_fps": round(stats.mrays_per_second_from_fps(width, height, fps), 3),
        "compile_s": round(t_compile, 1),
    }

    if device_time and chain > 1:
        chain_n = make_chain(chain)
        float(chain_n(arrays0))  # compile
        t1 = ms_1dispatch
        tn = min(
            _timed_window(chain_n, window_args, frames) for _ in range(reps)
        )
        device_ms = max((tn - t1) / (chain - 1), 1e-3)
        out["device_frame_ms"] = round(device_ms, 3)
        # Below ~50 us the slope is inside the wall-clock jitter of the
        # two windows it is differenced from — an Mrays number computed
        # from it would be noise dressed up as throughput (round-2's
        # config #1 printed 765 GRays/s that way). Report the honest
        # bound instead.
        if device_ms < 0.05:
            out["device_frame_ms_below_resolution"] = True
            out["mrays_dispatch"] = None
        else:
            out["mrays_dispatch"] = round(
                stats.mrays_per_second_from_dispatch_ms(width, height, device_ms), 3
            )
    return out


def main(argv=None) -> int:
    import jax

    from gpuraytracer.models.scenes import BENCH_CONFIGS, get_config
    from gpuraytracer.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--configs", type=str, default="",
                   help="comma-separated names (default: all five)")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--reps", type=int, default=3,
                   help="timed windows per metric (median reported)")
    p.add_argument("--chain", type=int, default=3,
                   help="frames per chained program for device-time slope")
    p.add_argument("--wall-chain", type=int, default=64,
                   help="animated frames per wall dispatch window"
                        " (bench.py headline methodology; 1 = every frame"
                        " its own dispatch)")
    p.add_argument("--no-device-time", action="store_true",
                   help="skip the chained-program device-time measurement")
    p.add_argument("--scale", type=float, default=1.0,
                   help="resolution scale factor (CI smoke runs)")
    p.add_argument("--json", type=str, default="")
    args = p.parse_args(argv)

    if jax.devices()[0].platform != "gpu":
        print(f"bench_suite needs a GPU; JAX found {jax.devices()[0]}",
              file=sys.stderr)
        return 1
    configs = (
        [get_config(n) for n in args.configs.split(",") if n]
        if args.configs
        else list(BENCH_CONFIGS)
    )
    results = []
    for cfg in configs:
        r = bench_config(cfg, args.frames, args.warmup, args.scale,
                         reps=args.reps, chain=args.chain,
                         device_time=not args.no_device_time,
                         wall_chain=args.wall_chain)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
