from gpuraytracer.parallel import device, pipeline, sharding

__all__ = ["device", "pipeline", "sharding"]
