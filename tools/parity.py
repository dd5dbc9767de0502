"""Cross-backend radiance parity harness.

Renders the builtin scene at a real resolution on the current backend and
compares it pixel by pixel with the CPU-backend reference render (the WARP
analog and golden pinning target). On a GPU the result is labelled by the
route the SDF march takes there ("gpu_triton"); elsewhere by the backend.

Metrics per route:
  pct_within_1e3      fraction of pixels with max-RGBA |diff| <= 1e-3
  mean_abs            mean |diff|
  interior_pct_1e3    same fraction over NON-silhouette pixels (3x3
                      neighborhood range of the CPU image < 0.05) — march
                      threshold crossings at silhouettes flip by last-ulp
                      fma differences; interior pixels must be tight.
  edge_fraction       how much of the image the silhouette mask covers
  sens_fraction       measured per-pixel chaos mask: pixels whose CPU
                      render moves > 1e-3 under a 1e-6 camera perturbation
                      (see sensitivity_mask) — the honest write-off set
  stable_pct_1e3      fraction of NON-chaotic pixels within the budget —
                      the primary cross-backend accuracy bar

The CPU reference and its three perturbed renders are computed in one
child process with JAX_PLATFORMS=cpu (this process owns the accelerator),
and cached under out/.

Usage: python tools/parity.py [--width 640 --height 360] [--out PARITY.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

T_ANIM = 0.7
# Multi-directional chaos probe: the mask is the union of hypersensitive
# sets over three ulp-scale camera perturbations (a pixel can be stable
# along one direction yet knife-edge along another).
PROBES = (1e-6, -1e-6, (1e-6, -1e-6, 1e-6))

_CPU_SRC = """
import dataclasses
import numpy as np
from gpuraytracer.utils.compile_cache import setup_compile_cache
setup_compile_cache()
from gpuraytracer.models import builtin
from gpuraytracer.render import trace
W, H = {width}, {height}
scene = builtin.build_scene(aspect=W / H, elapsed_time={t})
render = trace.make_renderer(scene.layout, W, H)
for path, eps in {jobs!r}:
    arrays = scene.arrays
    if eps is not None:
        cp = np.asarray(arrays.constants.camera_position)
        e = np.atleast_1d(np.asarray(eps, dtype=cp.dtype))
        delta = np.zeros_like(cp)
        if e.size > 1:
            delta[:3] += e
        else:
            delta += e[0]
        c = dataclasses.replace(
            arrays.constants,
            camera_position=arrays.constants.camera_position + delta)
        arrays = dataclasses.replace(arrays, constants=c)
    np.save(path, np.asarray(render(arrays)))
    print("cpu reference ->", path, flush=True)
"""


def reference_paths(width, height, out_dir=None):
    out_dir = out_dir or os.path.join(REPO, "out")
    ref = os.path.join(out_dir, f"parity_cpu_{width}x{height}.npy")
    eps = [os.path.join(out_dir, f"parity_cpu_eps{i}_{width}x{height}.npy")
           for i in range(len(PROBES))]
    return ref, eps


def start_cpu_references(width, height, out_dir=None):
    """Start the child that renders the missing CPU references; returns the
    Popen (None when every reference is cached)."""
    ref, eps = reference_paths(width, height, out_dir)
    jobs = [(p, e) for p, e in zip([ref] + eps, (None,) + PROBES)
            if not os.path.exists(p)]
    if not jobs:
        return None
    os.makedirs(os.path.dirname(ref), exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    src = _CPU_SRC.format(width=width, height=height, t=T_ANIM, jobs=jobs)
    return subprocess.Popen([sys.executable, "-c", src], cwd=REPO, env=env)


def load_references(width, height, out_dir=None):
    """(CPU reference image, chaos mask)."""
    import numpy as np

    ref_path, eps_paths = reference_paths(width, height, out_dir)
    ref = np.load(ref_path)
    sens = None
    for p in eps_paths:
        m = sensitivity_mask(ref, np.load(p))
        sens = m if sens is None else (sens | m)
    return ref, sens


def silhouette_mask(ref, thresh=0.05):
    """True where the 3x3 neighborhood of the CPU image varies strongly —
    geometry/shading edges where threshold-crossing flips live."""
    import numpy as np

    lum = ref[..., :3].max(axis=-1)
    lo = lum.copy()
    hi = lum.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(np.roll(lum, dy, axis=0), dx, axis=1)
            lo = np.minimum(lo, shifted)
            hi = np.maximum(hi, shifted)
    return (hi - lo) > thresh


def sensitivity_mask(ref, ref_eps, thresh=1e-3):
    """True where the CPU render itself moves more than `thresh` under an
    ulp-scale camera perturbation (1e-6 on a ~10-unit eye position).

    A pixel whose radiance flips under a last-ulp input change
    (march-threshold crossings, crawl-lane shadow booleans) cannot be
    expected to agree across backends whose fma/libm rounding differs by
    exactly that much; every other pixel has no such excuse and must meet
    the budget."""
    import numpy as np

    return np.abs(ref_eps - ref).max(axis=-1) > thresh


def compare(img, ref, sens=None):
    import numpy as np

    diff = np.abs(img - ref).max(axis=-1)
    edge = silhouette_mask(ref)
    interior = ~edge
    out = {
        "pct_within_1e3": float((diff <= 1e-3).mean()) * 100,
        "mean_abs": float(diff.mean()),
        "p99_abs": float(np.quantile(diff, 0.99)),
        "interior_pct_1e3": float((diff[interior] <= 1e-3).mean()) * 100,
        "interior_max_abs": float(diff[interior].max()),
        "edge_fraction": float(edge.mean()) * 100,
    }
    if sens is not None:
        stable = ~sens
        out["sens_fraction"] = float(sens.mean()) * 100
        out["stable_pct_1e3"] = float((diff[stable] <= 1e-3).mean()) * 100
        out["stable_p999_abs"] = float(np.quantile(diff[stable], 0.999))
        out["stable_max_abs"] = float(diff[stable].max())
    return out


def route() -> str:
    """Label of the path this backend renders through."""
    import jax

    backend = jax.default_backend()
    return "gpu_triton" if backend == "gpu" else backend


def render_current(width, height):
    """The builtin frame at T_ANIM on this process's default backend."""
    import jax
    import numpy as np

    from gpuraytracer.models import builtin
    from gpuraytracer.render import trace

    scene = builtin.build_scene(aspect=width / height, elapsed_time=T_ANIM)
    img = trace.make_renderer(scene.layout, width, height)(scene.arrays)
    return np.asarray(jax.block_until_ready(img))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--out", type=str, default=os.path.join(REPO, "PARITY.json"))
    args = p.parse_args()
    W, H = args.width, args.height

    from gpuraytracer.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    child = start_cpu_references(W, H)
    import jax

    img = render_current(W, H)
    if child is not None and child.wait() != 0:
        raise SystemExit(f"CPU reference render failed (rc={child.returncode})")
    ref, sens = load_references(W, H)
    dev = jax.devices()[0]
    results = {"width": W, "height": H, "t": T_ANIM,
               "device": {"platform": dev.platform, "kind": dev.device_kind},
               route(): compare(img, ref, sens)}
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
