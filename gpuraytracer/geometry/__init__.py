from gpuraytracer.geometry import analytic, fractal, metaballs, registry, sdf

__all__ = ["analytic", "fractal", "metaballs", "registry", "sdf"]
