"""Live HTTP preview — the swapchain-present analog for headless rendering.

SURVEY.md §2.2 maps the reference's Win32 window to "image size + resize +
output sink (file/HTTP preview)". This serves the latest rendered frame at
http://host:port/ with an auto-refreshing page, while a background loop
keeps rendering animated frames (the PeekMessage/WM_PAINT pump analog).

Usage:
  python -m gpuraytracer.apps.serve --width 640 --height 360 --port 8000
"""

from __future__ import annotations

import argparse
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from gpuraytracer.utils.log import get_logger

log = get_logger("serve")

_PAGE = b"""<!doctype html>
<html><head><title>gpuraytracer</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;height:100vh}
img{image-rendering:pixelated;max-width:96vw;max-height:90vh}
p{color:#ccc;font:12px monospace;text-align:center}</style></head>
<body><div><img id="f" src="/frame.png">
<p id="s"></p></div>
<script>
const img=document.getElementById('f');const s=document.getElementById('s');
setInterval(async()=>{const r=await fetch('/stats');s.textContent=await r.text();
img.src='/frame.png?'+Date.now();},500);
</script></body></html>"""


class PreviewState:
    def __init__(self):
        self.lock = threading.Lock()
        self.png_bytes: bytes = b""
        self.status: str = "rendering first frame..."
        self.error: str = ""
        # Resize requested over HTTP; applied by the render thread between
        # frames (the WM_SIZE-on-the-message-thread analog).
        self.pending_size = None
        self.frames = 0
        self.stop = threading.Event()


def render_loop(state: PreviewState, width: int, height: int, platform: str):
    try:
        _render_loop(state, width, height, platform)
    except Exception as e:  # surfaced to clients as HTTP 500
        log.exception("render thread failed")
        with state.lock:
            state.error = f"{type(e).__name__}: {e}"


def _render_loop(state: PreviewState, width: int, height: int, platform: str):
    import jax

    if platform != "auto":
        jax.config.update("jax_platforms", platform)
    import numpy as np

    from gpuraytracer.parallel.device import pick_device
    from gpuraytracer.render.renderer import Renderer
    from gpuraytracer.utils import png as png_mod
    from gpuraytracer.utils.compile_cache import setup_compile_cache
    from gpuraytracer.utils.stats import FrameStats

    setup_compile_cache()
    info = pick_device(platform)
    log.info("device: %s", info.description)
    renderer = Renderer(width, height)
    stats = FrameStats(width, height)
    t0 = time.monotonic()
    while not state.stop.is_set():
        with state.lock:
            pending = state.pending_size
            state.pending_size = None
        if pending:
            # Window.on_size_changed -> Renderer::on_size_changed chain:
            # rebuilds camera constants + the size-baked frame program.
            renderer.resize(*pending)
            stats = FrameStats(*renderer.size)
        t = time.monotonic() - t0
        img = np.asarray(renderer.render(t))
        data = png_mod.encode_png(png_mod.image_f32_to_rgba8(img))
        snap = stats.frame_rendered()
        with state.lock:
            state.png_bytes = data
            state.frames += 1
            if snap:
                state.status = stats.status_line(info.description)


def make_handler(state: PreviewState):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/frame.png"):
                with state.lock:
                    data = state.png_bytes
                    error = state.error
                if error:
                    self.send_response(500)
                    self.send_header("Content-Type", "text/plain")
                    self.end_headers()
                    self.wfile.write(error.encode())
                    return
                if not data:
                    self.send_response(503)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)
            elif self.path.startswith("/resize"):
                # /resize?w=640&h=360 — the WM_SIZE analog.
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                try:
                    w = int(q["w"][0])
                    h = int(q["h"][0])
                except (KeyError, ValueError):
                    self.send_response(400)
                    self.end_headers()
                    return
                # Explicit bounds check (not an assert: python -O strips
                # asserts and huge/non-positive sizes would reach the
                # render thread and trigger unbounded recompiles).
                if not (8 <= w <= 7680 and 8 <= h <= 4320):
                    self.send_response(400)
                    self.end_headers()
                    return
                with state.lock:
                    state.pending_size = (w, h)
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.end_headers()
                self.wfile.write(f"resizing to {w}x{h}".encode())
            elif self.path.startswith("/stats"):
                with state.lock:
                    status = state.status
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.end_headers()
                self.wfile.write(status.encode())
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE)

        def log_message(self, *args):
            pass

    return Handler


def start(width: int, height: int, platform: str = "auto", port: int = 8000,
          host: str = "0.0.0.0"):
    """Start the render thread and the HTTP server thread. Returns
    (server, state, render_thread); server.shutdown() plus state.stop.set()
    end both."""
    state = PreviewState()
    render = threading.Thread(
        target=render_loop, args=(state, width, height, platform),
        daemon=True,
    )
    render.start()
    server = ThreadingHTTPServer((host, port), make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, state, render


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--platform", choices=("auto", "gpu", "cpu"), default="auto")
    args = p.parse_args(argv)

    server, state, render = start(args.width, args.height, args.platform,
                                  args.port)
    log.info("preview at http://localhost:%d (%dx%d)", args.port, args.width, args.height)
    try:
        render.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        state.stop.set()
    return 0 if not state.error else 1


if __name__ == "__main__":
    raise SystemExit(main())
