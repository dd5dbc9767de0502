"""ctypes loader for the native host runtime (hostrt.cpp).

Builds the shared library on demand with g++ (cached next to this file
under build/); every entry point has a pure-python fallback so the
framework works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hostrt.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libhostrt.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
        _SRC, "-o", _SO_PATH,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _SO_PATH
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _SO_PATH
        if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(_SRC):
            path = _build()
        if path is None or not os.path.exists(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.hostrt_now_ns.restype = ctypes.c_int64
        lib.hostrt_write_png.restype = ctypes.c_int
        lib.hostrt_write_png.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.hostrt_writer_create.restype = ctypes.c_void_p
        lib.hostrt_writer_create.argtypes = [ctypes.c_int]
        lib.hostrt_writer_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.hostrt_writer_drain.argtypes = [ctypes.c_void_p]
        lib.hostrt_writer_written.restype = ctypes.c_int64
        lib.hostrt_writer_written.argtypes = [ctypes.c_void_p]
        lib.hostrt_writer_errors.restype = ctypes.c_int64
        lib.hostrt_writer_errors.argtypes = [ctypes.c_void_p]
        lib.hostrt_writer_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def now_seconds() -> float:
    lib = _load()
    if lib is None:
        return time.monotonic()
    return lib.hostrt_now_ns() / 1e9


def write_png(path: str, rgba: np.ndarray) -> None:
    lib = _load()
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {rgba.shape} {rgba.dtype}")
    if lib is None:
        from gpuraytracer.utils.png import encode_png

        with open(path, "wb") as f:
            f.write(encode_png(rgba))
        return
    h, w, c = rgba.shape
    rc = lib.hostrt_write_png(
        path.encode(), rgba.ctypes.data_as(ctypes.c_void_p), w, h, c
    )
    if rc != 0:
        raise IOError(f"hostrt_write_png failed with rc={rc} for {path}")


class AsyncFrameWriter:
    """Background PNG writer with bounded queue — overlaps image IO with
    device rendering (the present-queue analog). Falls back to synchronous
    writes when the native library is unavailable."""

    def __init__(self, max_depth: int = 3):
        self._lib = _load()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.hostrt_writer_create(max_depth)

    def submit(self, path: str, rgba: np.ndarray) -> None:
        rgba = np.ascontiguousarray(rgba)
        if self._handle is None:
            write_png(path, rgba)
            return
        h, w, c = rgba.shape
        self._lib.hostrt_writer_submit(
            self._handle, path.encode(), rgba.ctypes.data_as(ctypes.c_void_p), w, h, c
        )

    def drain(self) -> None:
        if self._handle is not None:
            self._lib.hostrt_writer_drain(self._handle)

    @property
    def frames_written(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.hostrt_writer_written(self._handle))

    @property
    def errors(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.hostrt_writer_errors(self._handle))

    def close(self) -> None:
        if self._handle is not None:
            self.drain()
            self._lib.hostrt_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
