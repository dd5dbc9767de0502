"""Failure detection & recovery — the device-removed handling analog.

The reference detects DXGI_ERROR_DEVICE_REMOVED on Present, tears down all
device objects and recreates them via IDeviceNotify callbacks
(DeviceResources.cpp:465-509,575-585; Renderer.cpp:184-195). The
analog here: catch device/runtime errors from a step, invoke on_device_lost /
on_device_restored hooks, rebuild the jitted function (dropping poisoned
executables/buffers), and retry with bounded attempts.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Callable, Optional

import jax

from gpuraytracer.utils.log import get_logger

log = get_logger("recovery")

# Error types indicating the device/runtime died rather than a programming
# bug (the DEVICE_REMOVED vs E_INVALIDARG distinction):
#   - jax.errors.JaxRuntimeError: XLA-level faults (device errors, lost
#     devices, out-of-memory).
#   - RuntimeError: PJRT plugins raise bare RuntimeErrors for driver
#     faults.
#   - OSError/ConnectionError: transport failures of remote devices.
# Programming bugs (TypeError, ValueError, shape errors) stay fatal.
_DEVICE_ERRORS = (
    jax.errors.JaxRuntimeError,
    RuntimeError,
    OSError,
)


def _is_device_error(e: BaseException) -> bool:
    """DEVICE_REMOVED vs E_INVALIDARG: a RuntimeError that is actually a
    jax trace/user error (e.g. ConcretizationTypeError subclasses) is a
    programming bug, not a device loss."""
    if isinstance(e, jax.errors.JAXTypeError):
        return False
    return isinstance(e, _DEVICE_ERRORS)


class DeviceLostError(RuntimeError):
    pass


class DeviceTimeoutError(RuntimeError):
    """A step exceeded the watchdog deadline — a wedged device (process
    alive at ~0% CPU, step never returns). Escalated like a device loss:
    the executor rebuilds and retries in a fresh executable."""


class RecoveringExecutor:
    """Runs a step function with device-lost detection and re-create/retry.

    make_step: builds a fresh jitted step (called at init and after every
    device loss — the create_device_dependent_resources analog).
    """

    def __init__(
        self,
        make_step: Callable[[], Callable],
        max_retries: int = 2,
        retry_delay_seconds: float = 5.0,
        on_device_lost: Optional[Callable[[], None]] = None,
        on_device_restored: Optional[Callable[[], None]] = None,
        watchdog_seconds: Optional[float] = None,
    ):
        self._make_step = make_step
        self._max_retries = max_retries
        self._retry_delay = retry_delay_seconds
        self._on_lost = on_device_lost
        self._on_restored = on_device_restored
        self._watchdog = watchdog_seconds
        self._pool = None
        if watchdog_seconds is not None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._step = make_step()
        self.recoveries = 0

    def _run_once(self, args, kwargs):
        out = self._step(*args, **kwargs)
        # Surface asynchronous device faults here rather than at an
        # arbitrary later use (the Present-time check analog).
        jax.block_until_ready(out)
        return out

    def __call__(self, *args, **kwargs):
        attempt = 0
        while True:
            try:
                if self._pool is None:
                    return self._run_once(args, kwargs)
                # Watchdog form: the step runs on a worker thread with a
                # deadline; a wedged device (silent hang) becomes a
                # DeviceTimeoutError and recovers like a device loss.
                fut = self._pool.submit(self._run_once, args, kwargs)
                try:
                    return fut.result(timeout=self._watchdog)
                except concurrent.futures.TimeoutError:
                    # Abandon the wedged worker (it may never return) so
                    # the retry does not queue behind it.
                    self._pool.shutdown(wait=False)
                    self._pool = concurrent.futures.ThreadPoolExecutor(
                        max_workers=1
                    )
                    raise DeviceTimeoutError(
                        f"step exceeded {self._watchdog}s watchdog"
                    ) from None
            except BaseException as e:
                if not (_is_device_error(e) or isinstance(e, DeviceTimeoutError)):
                    raise
                attempt += 1
                if attempt > self._max_retries:
                    raise DeviceLostError(
                        f"device error persisted after {self._max_retries} retries"
                    ) from e
                log.warning(
                    "device error (%s); recovery attempt %d/%d",
                    type(e).__name__, attempt, self._max_retries,
                )
                if self._on_lost:
                    self._on_lost()
                jax.clear_caches()
                time.sleep(self._retry_delay)
                self._step = self._make_step()
                if self._on_restored:
                    self._on_restored()
                self.recoveries += 1
