"""PNG encode/decode for framebuffer output.

The reference presents through a swapchain (DeviceResources::present);
headless rendering writes PNGs instead (SURVEY.md §2.2 "output sink").
Prefers the native C++ encoder in runtime/ (see runtime/hostrt.py) and
falls back to this pure-python implementation (stdlib zlib only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode (H, W, 3|4) uint8 to PNG bytes."""
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {rgba.dtype}")
    if rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {rgba.shape}")
    h, w, c = rgba.shape
    color_type = 6 if c == 4 else 2
    # Filter byte 0 (None) per scanline.
    raw = np.empty((h, 1 + w * c), dtype=np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = rgba.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _chunk(b"IHDR", ihdr),
            _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level)),
            _chunk(b"IEND", b""),
        ]
    )


def write_png(path: str, rgba: np.ndarray) -> None:
    try:
        from gpuraytracer.runtime import hostrt

        if hostrt.available():
            hostrt.write_png(path, rgba)
            return
    except Exception:
        pass
    with open(path, "wb") as f:
        f.write(encode_png(rgba))


def image_f32_to_rgba8(image) -> np.ndarray:
    """float radiance -> R8G8B8A8_UNORM (saturate + round), alpha forced
    opaque for viewing (the reference's alpha channel carries shading
    accumulation, not coverage)."""
    arr = np.asarray(image)
    out = np.clip(arr, 0.0, 1.0)
    out = np.rint(out * 255.0).astype(np.uint8)
    if out.shape[-1] == 4:
        out = out.copy()
        out[..., 3] = 255
    return out
