"""Timers — StepTimer and GPU/CPU timer equivalents.

Reference:
  StepTimer (QPC wall clock, fixed/variable timestep, 0.1 s delta clamp,
  leftover-tick accumulation, fps counting)  src/StepTimer.h:99-180
  DX::GPUTimer (timestamp queries, 0.95-EMA averages)
  src/PerformanceTimers.{h,cpp}

The equivalents here: a monotonic host clock drives animation (backed by the
native C++ runtime when built, falling back to time.monotonic), and device
timing is measured via block_until_ready deltas with the same 0.95-lerp
running average the reference applies to its GPU timestamps.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

# Ticks-per-second mirrors the reference's fixed-point tick unit
# (StepTimer.h ticks_per_second = 1e7, i.e. 100 ns ticks).
TICKS_PER_SECOND = 10_000_000
MAX_DELTA_SECONDS = 0.1  # delta clamp after pauses/breakpoints


def _default_clock() -> float:
    try:
        from gpuraytracer.runtime import hostrt

        if hostrt.available():
            return hostrt.now_seconds()
    except Exception:
        pass
    return time.monotonic()


class StepTimer:
    """Variable- or fixed-timestep frame timer."""

    def __init__(
        self,
        clock: Callable[[], float] = _default_clock,
        fixed_time_step: bool = False,
        target_delta_seconds: float = 1.0 / 60.0,
    ):
        self._clock = clock
        self._last = clock()
        self._elapsed = 0.0  # delta of the last tick
        self._total = 0.0
        self._leftover = 0.0
        self._frame_count = 0
        self._fps = 0
        self._frames_this_second = 0
        self._second_counter = 0.0
        self.fixed_time_step = fixed_time_step
        self.target_delta_seconds = target_delta_seconds

    def tick(self, update: Optional[Callable[[float], None]] = None) -> None:
        now = self._clock()
        delta = now - self._last
        self._last = now
        self._second_counter += delta
        # Clamp huge deltas (after a pause or breakpoint).
        delta = min(delta, MAX_DELTA_SECONDS)

        frames = self._frame_count
        if self.fixed_time_step:
            # Snap-to-target within 1/4000 s, like the reference, to avoid
            # drift against vsync-style cadences.
            if abs(delta - self.target_delta_seconds) < 1.0 / 4000.0:
                delta = self.target_delta_seconds
            self._leftover += delta
            while self._leftover >= self.target_delta_seconds:
                self._elapsed = self.target_delta_seconds
                self._total += self.target_delta_seconds
                self._leftover -= self.target_delta_seconds
                self._frame_count += 1
                if update:
                    update(self.target_delta_seconds)
        else:
            self._elapsed = delta
            self._total += delta
            self._leftover = 0.0
            self._frame_count += 1
            if update:
                update(delta)

        if self._frame_count != frames:
            self._frames_this_second += self._frame_count - frames
        if self._second_counter >= 1.0:
            self._fps = self._frames_this_second
            self._frames_this_second = 0
            self._second_counter %= 1.0

    def reset_elapsed_time(self) -> None:
        self._last = self._clock()
        self._leftover = 0.0
        self._fps = 0
        self._frames_this_second = 0
        self._second_counter = 0.0

    @property
    def elapsed_seconds(self) -> float:
        return self._elapsed

    @property
    def total_seconds(self) -> float:
        return self._total

    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def frames_per_second(self) -> int:
        return self._fps


class EmaTimer:
    """Running-average span timer: new = lerp(avg, sample, 0.05), i.e. the
    reference GPU timer's 0.95 retention (PerformanceTimers.cpp:34-37)."""

    SMOOTHING = 0.95

    def __init__(self, clock: Callable[[], float] = _default_clock):
        self._clock = clock
        self._start: Optional[float] = None
        self._last_ms = 0.0
        self._avg_ms = 0.0
        self._samples = 0

    def start(self) -> None:
        self._start = self._clock()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("stop() without start()")
        self._last_ms = (self._clock() - self._start) * 1e3
        self._start = None
        if self._samples == 0:
            self._avg_ms = self._last_ms
        else:
            self._avg_ms = (
                self.SMOOTHING * self._avg_ms + (1.0 - self.SMOOTHING) * self._last_ms
            )
        self._samples += 1
        return self._last_ms

    @property
    def last_ms(self) -> float:
        return self._last_ms

    @property
    def average_ms(self) -> float:
        return self._avg_ms


class DeviceTimer(EmaTimer):
    """Times device work by bracketing with block_until_ready — the
    timestamp-query analog. Usage:
        with timer.measure(result_fn) as out: ...
    or start(); out = f(); stop_after(out).
    """

    def stop_after(self, value) -> float:
        import jax

        jax.block_until_ready(value)
        return self.stop()
