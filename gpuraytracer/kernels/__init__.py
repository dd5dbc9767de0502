from gpuraytracer.kernels import sdf_march, soa

__all__ = ["sdf_march", "soa"]
