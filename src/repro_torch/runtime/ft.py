"""Fault tolerance: step watchdog, straggler detection, retrying train loop.

At 1000+ node scale the failure modes this addresses:
  * hung steps (network partition, device wedged) -> watchdog raises after
    `timeout_s`, the loop restores from the last checkpoint and retries;
  * stragglers (slow host) -> per-step timing vs a running median; offenders
    are counted and surfaced so the scheduler can evict the host. Mitigation
    within a step is the collectives' own (they don't proceed without every
    peer), so detection + requeue-from-checkpoint is the actionable layer;
  * crash-restart -> the loop is re-entrant: it reads the newest checkpoint
    and the data pipeline is stateless-resumable (batch = f(seed, step)).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


class StepTimeout(Exception):
    pass


class Watchdog:
    """Context manager: raises StepTimeout in the main thread's next check if
    the step exceeds timeout_s (cooperative; a device step can't be
    interrupted preemptively from Python)."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._fired = threading.Event()
        self._timer: threading.Timer | None = None

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fired.set)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        assert self._timer is not None
        self._timer.cancel()
        return False

    @property
    def fired(self) -> bool:
        """Non-raising read of the timer state: the serving path
        (faults.degrade.EpochWatchdog) keeps the overrunning epoch's result
        and escalates a ladder instead of unwinding to a checkpoint."""
        return self._fired.is_set()

    def check(self):
        if self._fired.is_set():
            raise StepTimeout(f"step exceeded {self.timeout_s}s")


@dataclass
class StragglerDetector:
    threshold: float = 2.0        # x median
    window: int = 50
    times: list = field(default_factory=list)
    straggler_steps: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self.straggler_steps += 1
                return True
        return False


def run_with_retries(step_once, n_steps: int, restore_fn, max_retries: int = 3,
                     step_timeout_s: float = 600.0, on_straggler=None,
                     retryable: tuple[type[BaseException], ...] = ()):
    """Generic fault-tolerant loop. step_once(i) runs one step and must be
    idempotent-from-checkpoint; restore_fn() rewinds state after a failure.
    Returns (completed_steps, retries_used, straggler_steps).

    Only StepTimeout plus the caller's explicit ``retryable`` allowlist is
    retried. Anything else propagates immediately: a bare RuntimeError here
    is usually the runtime reporting a compile/OOM/device error, and restoring a
    checkpoint to re-run into the same error ``max_retries`` times masks
    the real failure (and can silently burn the retry budget)."""
    det = StragglerDetector()
    retry_types: tuple[type[BaseException], ...] = (StepTimeout,
                                                    *tuple(retryable))
    retries = 0
    i = 0
    while i < n_steps:
        try:
            with Watchdog(step_timeout_s) as wd:
                t0 = time.monotonic()
                step_once(i)
                wd.check()
            dt = time.monotonic() - t0
            if det.record(dt) and on_straggler is not None:
                on_straggler(i, dt)
            i += 1
        except retry_types:
            retries += 1
            if retries > max_retries:
                raise
            i = restore_fn()
    return i, retries, det.straggler_steps
