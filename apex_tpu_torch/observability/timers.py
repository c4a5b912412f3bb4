"""Dispatch-aware step timing + compile-event counting.

Raw ``time.perf_counter()`` around a jitted call measures *dispatch*
(often microseconds) or — when the caller immediately reads a result —
dispatch plus the device sync, silently including any recompile.  The
APX110 lint rule bans the raw pattern in package code; this module is
the sanctioned replacement:

* :func:`compile_count` — a process-wide counter of compile requests
  (the JAX package feeds it from ``jax.monitoring``; the PyTorch port
  runs eagerly, has no compile events, and reads 0);
* :class:`StepTimer` — brackets a step, reports wall seconds AND the
  compile-count delta, and flags a *recompile* only when a compile
  lands on a step after the first timed one (the warmup compile is the
  contract; a later one is the bug the ONE-donated-executable tests
  exist to catch).

The timer itself never touches device values: what falls inside the
bracket (pure dispatch, or dispatch + the caller's own host read of a
result it needed anyway) is the caller's choice, and the serving
scheduler deliberately closes the bracket after its token read so the
sample is the real per-token latency.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["StepSample", "StepTimer", "compile_count",
           "install_compile_listener"]

_COMPILE_EVENTS = 0
_LISTENER_INSTALLED = False


def _on_monitoring_event(name: str, **kwargs) -> None:
    global _COMPILE_EVENTS
    if "compile_requests" in name:
        _COMPILE_EVENTS += 1


def install_compile_listener() -> None:
    """Mark the compile listener installed.  PyTorch runs the port
    eagerly and emits no compile-request events, so nothing registers
    and :func:`compile_count` stays 0 (a warm engine never recompiles
    by construction)."""
    global _LISTENER_INSTALLED
    _LISTENER_INSTALLED = True


def compile_count() -> int:
    """XLA compile requests observed so far (listener installs lazily,
    so the first call starts the count at 0)."""
    install_compile_listener()
    return _COMPILE_EVENTS


@dataclass(frozen=True)
class StepSample:
    seconds: float
    compile_delta: int
    recompiled: bool          # a compile on a step AFTER the first


class StepTimer:
    """Times successive steps; ``last`` holds the newest
    :class:`StepSample`."""

    def __init__(self):
        install_compile_listener()
        self._t0: Optional[float] = None
        self._c0: int = 0
        self.steps_timed: int = 0
        self.last: Optional[StepSample] = None

    def start(self) -> None:
        if self._t0 is not None:
            raise RuntimeError("StepTimer.start() while already timing")
        self._c0 = compile_count()
        self._t0 = time.perf_counter()

    def stop(self) -> StepSample:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        seconds = time.perf_counter() - self._t0
        self._t0 = None
        delta = compile_count() - self._c0
        sample = StepSample(seconds=seconds, compile_delta=delta,
                            recompiled=delta > 0 and self.steps_timed > 0)
        self.steps_timed += 1
        self.last = sample
        return sample

    @contextlib.contextmanager
    def time_step(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()
