from gpuraytracer.models import animate, builtin

__all__ = ["animate", "builtin"]
