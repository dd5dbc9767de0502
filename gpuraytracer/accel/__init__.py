from gpuraytracer.accel import instances, traverse

__all__ = ["instances", "traverse"]
