"""CLI renderer — the main.cpp + Window frame-loop analog.

The reference pumps Win32 messages and renders on WM_PAINT into a swapchain
(main.cpp:43-52, Window.cpp:107-119); headless rendering steps the same
per-frame sequence — tick timer -> animate -> upload constants -> trace ->
present — writing PNGs through the native async writer instead of a
swapchain, with frame stats in the reference's window-title format.

Usage:
  python -m gpuraytracer.apps.render_cli --width 1280 --height 720 \
      --frames 60 --out out/frames --platform auto
"""

from __future__ import annotations

import argparse
import os
import sys

from gpuraytracer.core.config import RenderConfig
from gpuraytracer.utils.log import get_logger

log = get_logger("render_cli")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=1280)  # main.cpp:14 defaults
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", type=str, default="out/frames")
    p.add_argument("--time", type=float, default=0.0, help="animation start time (s)")
    p.add_argument("--dt", type=float, default=None,
                   help="fixed timestep (s); default: wall clock")
    p.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto")
    p.add_argument("--depth", type=int, default=3, help="max recursion depth")
    p.add_argument("--animate-camera", action="store_true")
    p.add_argument("--animate-light", action="store_true")
    p.add_argument("--no-animate-geometry", action="store_true")
    p.add_argument("--frames-in-flight", type=int, default=3)
    p.add_argument("--checkpoint", type=str, default="",
                   help="write animation-state checkpoint here after the run")
    p.add_argument("--resume", type=str, default="",
                   help="resume animation state from a checkpoint file")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import jax

    if args.platform != "auto":
        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    from gpuraytracer.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    from gpuraytracer.models import animate, builtin
    from gpuraytracer.parallel import device as device_mod
    from gpuraytracer.parallel.pipeline import FramePipeline
    from gpuraytracer.render import trace
    from gpuraytracer.runtime import hostrt
    from gpuraytracer.utils import png as png_mod
    from gpuraytracer.utils.stats import FrameStats
    from gpuraytracer.utils.timers import StepTimer

    config = RenderConfig(
        width=args.width,
        height=args.height,
        max_recursion_depth=args.depth,
        animate_geometry=not args.no_animate_geometry,
        animate_camera=args.animate_camera,
        animate_light=args.animate_light,
        platform=args.platform,
        frames_in_flight=args.frames_in_flight,
    )

    info = device_mod.pick_device(config.platform)
    log.info("device: %s", info.description)

    from gpuraytracer.utils import introspect

    log.info("%s", introspect.describe_backend())

    os.makedirs(args.out, exist_ok=True)

    start_frame = 0
    if args.resume:
        from gpuraytracer.utils import checkpoint as ckpt

        state, _, start_frame = ckpt.load(args.resume)
        log.info("resumed at frame %d, t=%.3f s", start_frame, state.geometry_time)
    else:
        state = animate.AnimationState.initial()
        state.geometry_time = args.time
    scene0 = state.scene(config.aspect_ratio)
    for line in introspect.describe_scene(scene0).splitlines():
        log.info("%s", line)
    renderer = trace.make_renderer(
        builtin.LAYOUT, config.width, config.height, max_depth=config.max_recursion_depth
    )
    pipe = FramePipeline(renderer, config.frames_in_flight)
    stats = FrameStats(
        config.width, config.height,
        on_update=lambda s: log.info("%s", stats.status_line(info.description)),
    )
    timer = StepTimer(
        fixed_time_step=args.dt is not None,
        target_delta_seconds=args.dt or (1.0 / 60.0),
    )

    writer = hostrt.AsyncFrameWriter(config.frames_in_flight)
    pending = []  # (frame_index, async image)

    def flush(entry):
        idx, img = entry
        arr = png_mod.image_f32_to_rgba8(np.asarray(img))
        writer.submit(os.path.join(args.out, f"frame_{idx:05d}.png"), arr)
        stats.frame_rendered()

    try:
        for i in range(start_frame, start_frame + args.frames):
            if args.dt is not None:
                state = state.tick(args.dt, config)
            else:
                timer.tick()
                state = state.tick(timer.elapsed_seconds, config)
            scene = state.scene(config.aspect_ratio)
            out, completed = pipe.submit(scene.arrays)
            pending.append((i, out))
            if completed is not None:
                flush(pending.pop(0))
        for img in pipe.drain():
            pass
        while pending:
            flush(pending.pop(0))
        writer.drain()
    finally:
        writer.close()

    if args.checkpoint:
        from gpuraytracer.utils import checkpoint as ckpt

        ckpt.save(args.checkpoint, state, config, start_frame + args.frames)
        log.info("checkpoint -> %s", args.checkpoint)

    log.info(
        "rendered %d frame(s) at %dx%d -> %s",
        args.frames, config.width, config.height, args.out,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
