from gpuraytracer.utils import log, png, stats, timers

__all__ = ["log", "png", "stats", "timers"]
