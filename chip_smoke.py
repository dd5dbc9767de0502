"""Smoke test of the renderer on one NVIDIA GPU, through its user entry points.

Phases, all in this one process, which owns the card (the CPU reference
for phase e renders in a child held to the CPU, which never opens it):

  a) card and device: the card's name and power limit, device kind, JAX
     version; exits non-zero unless JAX's first device is a GPU;
  b) main path: the builtin scene at 1920x1080, depth 3, geometry
     animation on, through apps/render_cli for 3 frames to PNG; compile
     seconds and per-frame device time of the same frame program;
  c) server: apps/serve in threads of this process answers 3 GET
     /frame.png at 1280x720, one after a resize to 640x360, then stops;
  d) kernel: for every SDF code, the Triton march (kernels/sdf_march.py)
     against the XLA march (geometry/sdf.sphere_trace) at 1920x1080 rays,
     both compiled for the card, with both times;
  e) frame parity: the GPU frame against the CPU reference at 640x360 with
     the chaos mask of tools/parity.py; writes out/PARITY_GPU.json.

`--four-cards` runs only the sharded path: parallel/sharding over 4 GPUs
at 1920x1080 against a one-card render of the same frame.

Any failed check raises and the script exits non-zero. The last line of
standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "out")
PLATFORM = "gpu"
MAIN_SIZE = (1920, 1080)  # render_cli and the sharded path
SERVE_SIZE, RESIZE = (1280, 720), (640, 360)
MARCH_SIZE = (1920, 1080)  # rays per SDF code in phase d
PARITY_SIZE = (640, 360)


def log(msg: str) -> None:
    print(msg, flush=True)


def query_card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi lists no GPU")
    return out.splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def decode_png(data: bytes):
    """(H, W, C) uint8 from the PNGs this repo writes (8-bit, filter 0)."""
    import numpy as np

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, w, h, c = 8, [], 0, 0, 4
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, _, color_type = struct.unpack(">IIBB", body[:10])
            c = 4 if color_type == 6 else 3
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    check((raw[:, 0] == 0).all(), "unexpected PNG row filter")
    return raw[:, 1:].reshape(h, w, c)


def timed_frames(fn, args_list):
    """Device time per call: host clock around work ending in
    block_until_ready. Returns (ms list, last output)."""
    import jax

    ms, out = [], None
    for args in args_list:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, out


# ---------------------------------------------------------------------------
# b) main path
# ---------------------------------------------------------------------------


def phase_main_path(card: str) -> None:
    import jax
    import numpy as np

    from gpuraytracer.apps import render_cli
    from gpuraytracer.models import builtin
    from gpuraytracer.render import trace

    w, h = MAIN_SIZE
    scene = builtin.build_scene(aspect=w / h, elapsed_time=0.0)
    render = trace.make_renderer(builtin.LAYOUT, w, h)
    animate = jax.jit(builtin.animate_arrays)
    frames = [(jax.block_until_ready(animate(scene.arrays, 0.0333 * i)),)
              for i in range(6)]
    ms, img = timed_frames(render, frames)
    img = np.asarray(img)
    check(img.shape == (h, w, 4), f"frame shape {img.shape}")
    check(bool(np.isfinite(img).all()), "non-finite radiance")
    check(float(img[..., :3].mean()) > 0.05, "frame is black")
    log(f"[b] builtin {w}x{h} depth 3: first frame {ms[0] / 1e3:.1f} s "
        f"(compile included), then {np.median(ms[1:]):.2f} ms median of "
        f"{len(ms) - 1} frames on {card}")

    out_dir = tempfile.mkdtemp(prefix="frames_", dir=OUT)
    t0 = time.perf_counter()
    rc = render_cli.main([
        "--width", str(w), "--height", str(h), "--frames", "3",
        "--dt", "0.0333", "--out", out_dir, "--platform", PLATFORM,
    ])
    wall = time.perf_counter() - t0
    check(rc == 0, f"render_cli returned {rc}")
    for i in range(3):
        path = os.path.join(out_dir, f"frame_{i:05d}.png")
        check(os.path.exists(path), f"{path} missing")
        with open(path, "rb") as f:
            px = decode_png(f.read())
        check(px.shape == (h, w, 4), f"{path}: shape {px.shape}")
        check(float(px[..., :3].mean()) > 10.0, f"{path} is black")
    log(f"[b] render_cli: 3 frames {w}x{h} to PNG in {wall:.1f} s wall "
        f"(compile included)")


# ---------------------------------------------------------------------------
# c) server
# ---------------------------------------------------------------------------


def _get(url: str, timeout: float = 600.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _png_size(data: bytes):
    w, h = struct.unpack(">II", data[16:24])
    return w, h


def _wait_for(pred, what: str, timeout: float = 600.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(what)
        time.sleep(0.05)


def phase_server(card: str) -> None:
    from gpuraytracer.apps import serve

    server, state, render = serve.start(*SERVE_SIZE, PLATFORM, port=0,
                                        host="127.0.0.1")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        _wait_for(lambda: state.frames > 0 or state.error, "first frame")
        check(not state.error, f"render thread: {state.error}")
        first_s = time.perf_counter() - t0
        sizes = []
        for _ in range(2):
            status, data = _get(base + "/frame.png")
            check(status == 200 and data[:4] == b"\x89PNG", "bad frame.png")
            sizes.append(_png_size(data))
        status, _ = _get(base + "/resize?w=%d&h=%d" % RESIZE)
        check(status == 200, "resize refused")
        t0 = time.perf_counter()

        def resized():
            check(not state.error, f"render thread: {state.error}")
            with state.lock:
                data = state.png_bytes
            return _png_size(data) == RESIZE

        _wait_for(resized, "resized frame")
        resize_s = time.perf_counter() - t0
        status, data = _get(base + "/frame.png")
        check(status == 200 and data[:4] == b"\x89PNG", "bad frame.png")
        sizes.append(_png_size(data))
        px = decode_png(data)
        check(float(px[..., :3].mean()) > 10.0, "served frame is black")
        check(sizes == [SERVE_SIZE, SERVE_SIZE, RESIZE],
              f"served sizes {sizes}")
        with state.lock:
            frames, status_line = state.frames, state.status
        log(f"[c] serve: 3 x GET /frame.png -> 200 PNG {sizes}; first frame "
            f"{first_s:.1f} s, resize {resize_s:.1f} s "
            f"(compiles included); {frames} frames rendered; status "
            f"'{status_line}'")
    finally:
        server.shutdown()
        server.server_close()
        state.stop.set()
        render.join(timeout=120)
    check(not render.is_alive(), "render thread did not stop")


# ---------------------------------------------------------------------------
# d) the Triton march against the XLA march
# ---------------------------------------------------------------------------


def march_inputs(code: int, width: int, height: int):
    """A camera's rays at one SDF primitive in its local space, gated and
    windowed the way accel/traverse.py does it."""
    import jax.numpy as jnp

    from gpuraytracer.geometry import analytic, sdf

    ys, xs = jnp.meshgrid(jnp.linspace(1.0, -1.0, height),
                          jnp.linspace(-16 / 9, 16 / 9, width), indexing="ij")
    eye = jnp.asarray([0.4, 0.9, -3.5], jnp.float32)
    target = jnp.stack([xs, ys, jnp.zeros_like(xs)], axis=-1)
    o = jnp.broadcast_to(eye, target.shape)
    d = target - eye
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    ext = code >= 7
    box = 1.0 if ext else 1.5
    lo, hi = analytic.aabb_interval(o, d, (-box,) * 3, (box,) * 3)
    gate = (hi > lo) & (hi > 0.0)
    t_lo = jnp.maximum(lo, 0.0) if ext else jnp.zeros_like(lo)
    t_hi = jnp.minimum(hi, 1e4) if ext else jnp.full_like(hi, 1e4)
    gate = gate & (t_hi > t_lo)
    return dict(o=o, d=d, gate=gate, t_lo=t_lo, t_hi=t_hi,
                cull=not ext, relax=sdf.relax_for_code(code),
                escape=code in sdf.ESCAPE_SAFE_CODES and not ext,
                steps=sdf.cap_radiance_budget(512))


def march_pair(code: int, a: dict):
    """(kernel fn, reference fn), both jitted over the same inputs."""
    import jax

    from gpuraytracer.geometry import sdf
    from gpuraytracer.kernels import sdf_march

    fn = sdf.DISTANCE_FUNCTIONS[code]

    def kernel(o, d, gate, lo, hi):
        return sdf_march.sphere_trace_lanes(
            o, d, gate, lo, hi, 1.0, a["steps"], prim_code=code,
            cull_backface=a["cull"], escape_bound=a["escape"],
            relax=a["relax"])

    def reference(o, d, gate, lo, hi):
        return sdf.sphere_trace(
            o, d, fn, step_scale=1.0, t_min=lo, t_max=hi,
            cull_backface=a["cull"], active=gate, max_steps=a["steps"],
            escape_bound=a["escape"], relax=a["relax"])

    return jax.jit(kernel), jax.jit(reference)


def phase_kernel(card: str) -> None:
    import numpy as np

    from gpuraytracer.kernels import soa

    failures = []
    for code in sorted(soa.DISTANCE_FUNCTIONS_SOA):
        a = march_inputs(code, *MARCH_SIZE)
        args = (a["o"], a["d"], a["gate"], a["t_lo"], a["t_hi"])
        kernel, reference = march_pair(code, a)
        kernel_ms, (hk, tk, nk) = timed_frames(kernel, [args] * 6)
        ref_ms, (hx, tx, nx) = timed_frames(reference, [args] * 6)
        hk, tk, nk, hx, tx, nx = map(np.asarray, (hk, tk, nk, hx, tx, nx))
        gate = np.asarray(a["gate"])
        agree = float((hk == hx)[gate].mean())
        both = hk & hx
        t_ok = float((np.abs(tk[both] - tx[both]) <= 1e-4).mean())
        n_err = np.abs(nk - nx).max(axis=-1)[both]
        n_1e3 = float((n_err <= 1e-3).mean())
        n_1e2 = float((n_err <= 1e-2).mean())
        log(f"[d] code {code}: triton {np.median(kernel_ms[1:]):.3f} ms, "
            f"xla {np.median(ref_ms[1:]):.3f} ms; {gate.sum()} gated lanes, "
            f"{both.sum()} hit; hit agree {agree:.5f}, t<=1e-4 {t_ok:.5f}, "
            f"normal<=1e-3 {n_1e3:.5f}, <=1e-2 {n_1e2:.5f} "
            f"(max {n_err.max():.2e}) on {card}")
        # Bars: hit masks and t as the kernel's own contract; normals at
        # 1e-2 (the tetrahedral gradient turns one-ulp distance
        # differences into ~1e-3 normal differences, see tests).
        if not (agree >= 0.999 and t_ok >= 0.999 and n_1e2 >= 0.999):
            failures.append(code)
    check(not failures, f"kernel disagrees with the reference for {failures}")


# ---------------------------------------------------------------------------
# e) frame parity against the CPU reference
# ---------------------------------------------------------------------------

PARITY_BARS = {"pct_within_1e3": 89.0, "interior_pct_1e3": 95.5,
               "stable_pct_1e3": 95.5}


def phase_parity(card: str, child) -> None:
    import jax

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import parity

    w, h = PARITY_SIZE
    img = parity.render_current(w, h)
    if child is not None:
        rc = child.wait(timeout=1000)
        check(rc == 0, f"CPU reference child failed (rc={rc})")
    ref, sens = parity.load_references(w, h)
    dev = jax.devices()[0]
    result = parity.compare(img, ref, sens)
    artifact = {"width": w, "height": h, "t": parity.T_ANIM, "card": card,
                "device": {"platform": dev.platform, "kind": dev.device_kind},
                parity.route(): result}
    with open(os.path.join(OUT, "PARITY_GPU.json"), "w") as f:
        json.dump(artifact, f, indent=2)
    log("[e] parity " + json.dumps(artifact))
    for key, bar in PARITY_BARS.items():
        check(result[key] >= bar, f"parity {key} {result[key]:.3f} < {bar}")


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------


def phase_four_cards(card: str) -> None:
    import jax
    import numpy as np

    from gpuraytracer.models import builtin
    from gpuraytracer.parallel import sharding
    from gpuraytracer.render import trace

    devices = jax.devices()
    check(len(devices) == 4, f"need 4 GPUs, JAX sees {len(devices)}")
    w, h = MAIN_SIZE
    scene = builtin.build_scene(aspect=w / h, elapsed_time=0.7)
    sharded = sharding.make_sharded_renderer(
        scene.layout, w, h, sharding.make_mesh(devices))
    ms, img = timed_frames(sharded, [(scene.arrays,)] * 4)
    log(f"[4] sharded {w}x{h} over 4 cards: first call {ms[0] / 1e3:.1f} s "
        f"(compile included), then {np.median(ms[1:]):.2f} ms median "
        f"on 4 x {card}")
    img4 = sharding.gather_image(img)
    single = trace.make_renderer(scene.layout, w, h)  # on the default card
    t0 = time.perf_counter()
    img1 = np.asarray(jax.block_until_ready(single(scene.arrays)))
    log(f"[4] one-card render: {time.perf_counter() - t0:.1f} s "
        f"(compile included)")
    diff = np.abs(img4 - img1).max(axis=-1)
    within = float((diff <= 1e-3).mean())
    log(f"[4] sharded vs one card: {within * 100:.4f}% of pixels within "
        f"1e-3, max {diff.max():.3e}")
    check(bool(np.isfinite(img4).all()), "non-finite sharded radiance")
    check(within >= 0.999, f"only {within * 100:.4f}% of pixels within 1e-3")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded 4-GPU path and its check")
    args = p.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "gpuraytracer")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    # The card is found before JAX is imported, so a host without one never
    # initializes an accelerator backend.
    try:
        card = query_card()
    except (OSError, subprocess.SubprocessError, RuntimeError) as e:
        print(f"no NVIDIA GPU: {e}", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import jax

    from gpuraytracer.utils.compile_cache import setup_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"JAX found no GPU (first device: {dev})", file=sys.stderr)
        return 1
    setup_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    log(f"[a] {card}; JAX {jax.__version__}; {len(jax.devices())} x "
        f"{dev.device_kind}")

    if args.four_cards:
        phase_four_cards(card)
    else:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        import parity

        # The CPU reference renders in a child held to the CPU while this
        # process works on the card.
        child = parity.start_cpu_references(*PARITY_SIZE)
        try:
            for phase in (phase_main_path, phase_server, phase_kernel):
                t0 = time.perf_counter()
                phase(card)
                log(f"    ({phase.__name__} {time.perf_counter() - t0:.1f} s)")
            phase_parity(card, child)
        finally:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
