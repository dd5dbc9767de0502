"""gpuraytracer — a wavefront raytracing framework in JAX.

A ground-up JAX / XLA / Pallas re-design of the capabilities of the
0GreenClover0/GPURaytracer reference (a D3D12 DXR hardware raytracer):
the DXR shader table becomes a statically-dispatched intersector registry,
the per-ray recursive TraceRay becomes an unrolled depth-3 wavefront loop
over dense ray batches, and the TLAS/BLAS acceleration path becomes a
flattened instance-AABB structure traversed with vectorized slab tests.

Layout
------
core/       ABI dataclasses, HLSL-compatible math, camera, config
geometry/   intersectors: analytic, SDF library, fractal, metaballs + registry
accel/      instance set (transforms + world AABBs) and traversal
render/     wavefront integrator, Phong/Fresnel/fog shading, checkerboard
kernels/    Pallas (Triton) GPU kernel for the SDF march + its SoA library
parallel/   device selection, mesh, sharded (multi-chip) rendering, pipelining
models/     built-in scenes (the reference scene + benchmark configs), animation
utils/      timers, frame stats, image IO, logging
apps/       CLI renderer and benchmark harness
runtime/    native C++ host runtime (timers, PNG encode, frame pacing)
"""

from gpuraytracer.version import __version__

__all__ = ["__version__"]
