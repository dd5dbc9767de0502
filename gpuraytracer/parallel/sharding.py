"""Multi-chip rendering: pixel-grid data parallelism over a device mesh.

The reference's only parallelism is the implicit SIMT width of
DispatchRays(W, H, 1) on one GPU (SURVEY.md §2.14). Scale-out here is data
parallelism over pixels: shard the pixel rows across a 1-D mesh under
shard_map — each device renders a horizontal band. Rendering is
embarrassingly parallel; the only cross-device traffic is the optional
frame-stats psum and the output gather (left to jax's global array
machinery).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpuraytracer.accel.instances import Scene, SceneLayout
from gpuraytracer.core import camera as cam
from gpuraytracer.render.trace import trace_radiance


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "x") -> Mesh:
    """1-D render mesh. For the builtin workload the natural mesh is all
    chips on one axis; pixel rows shard across it."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_sharded_renderer(
    layout: SceneLayout,
    width: int,
    height: int,
    mesh: Mesh,
    *,
    axis_name: str = "x",
    max_depth: int = 3,
    compute_stats: bool = False,
):
    """jit-compiled multi-chip frame function.

    Each device traces its band of pixel rows; `height` must divide evenly
    by the mesh size (pad upstream if needed). Returns image (H, W, 4) laid
    out row-sharded across the mesh; with compute_stats also returns the
    mean radiance (psum across devices — the cross-device metrics
    reduction).
    """
    n = mesh.devices.size
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by mesh size {n}")

    def tile(px, py, arrays):
        scene = Scene(layout, arrays)
        origins, directions = cam.generate_camera_rays(
            px, py, width, height,
            arrays.constants.camera_position,
            arrays.constants.projection_to_world,
        )
        color = trace_radiance(
            origins, directions, px, py, width, height, scene,
            max_depth=max_depth,
        )
        if compute_stats:
            local_sum = jnp.sum(color[..., :3])
            total = jax.lax.psum(local_sum, axis_name)
            return color, total / (width * height * 3)
        return color

    sharded = jax.shard_map(
        tile,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P()),
        out_specs=(P(axis_name, None, None), P()) if compute_stats else P(axis_name, None, None),
    )

    px, py = cam.pixel_grid(width, height)
    row_sharding = NamedSharding(mesh, P(axis_name, None))
    px = jax.device_put(px, row_sharding)
    py = jax.device_put(py, row_sharding)

    @jax.jit
    def render(arrays):
        return sharded(px, py, arrays)

    return render


def gather_image(image) -> np.ndarray:
    """Assemble the row-sharded global array on the host."""
    return np.asarray(jax.device_get(image))
