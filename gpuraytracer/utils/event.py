"""Typed event dispatch — the AK::Event analog (src/AK/Event.h:17-122).

The reference's thread-safe weak-ref listener event is used exactly once:
window resize -> renderer (Renderer.cpp:58). This is the plain-callback
equivalent with the same auto-cleanup of dead listeners (weakref-bound
methods drop out when their owner is collected).
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class Event(Generic[T]):
    def __init__(self):
        self._lock = threading.Lock()
        self._listeners: List[object] = []

    def attach(self, fn: Callable) -> None:
        with self._lock:
            if hasattr(fn, "__self__"):
                try:
                    self._listeners.append(weakref.WeakMethod(fn))
                    return
                except TypeError:
                    pass  # builtin / non-weakrefable receiver: strong ref
            self._listeners.append(fn)

    def detach(self, fn: Callable) -> None:
        with self._lock:
            self._listeners = [
                l for l in self._listeners
                if not (isinstance(l, weakref.WeakMethod) and l() == fn) and l != fn
            ]

    def __call__(self, *args, **kwargs) -> None:
        with self._lock:
            listeners = list(self._listeners)
        dead = []
        for l in listeners:
            if isinstance(l, weakref.WeakMethod):
                fn = l()
                if fn is None:
                    dead.append(l)
                    continue
                fn(*args, **kwargs)
            else:
                l(*args, **kwargs)
        if dead:
            with self._lock:
                self._listeners = [l for l in self._listeners if l not in dead]

    @property
    def listener_count(self) -> int:
        with self._lock:
            return len(self._listeners)


class Viewport:
    """Headless viewport — the Window analog (SURVEY.md §2.2): image size,
    aspect ratio, resize event. No OS window; the output sink is the
    PNG/async-writer path."""

    def __init__(self, width: int, height: int, title: str = "gpuraytracer"):
        self.width = width
        self.height = height
        self.title = title
        self.on_size_changed: Event = Event()

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def resize(self, width: int, height: int) -> None:
        if (width, height) == (self.width, self.height):
            return  # the reference also ignores no-op resizes
        self.width = width
        self.height = height
        self.on_size_changed(width, height)

    def set_title(self, text: str) -> None:
        """set_custom_window_text analog — stores the frame-stats line."""
        self.title = text
