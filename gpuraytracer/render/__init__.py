from gpuraytracer.render import checkers, shade, trace

__all__ = ["checkers", "shade", "trace"]
