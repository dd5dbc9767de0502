from gpuraytracer.core import camera, config, hlsl, types

__all__ = ["camera", "config", "hlsl", "types"]
