"""Crash supervisor: restart a killed serving loop from durable state.

The supervisor owns the epoch loop that ``OnlineLoop.run`` would otherwise
drive, adding the durability hooks around each step:

  * cut snapshots on the store's cadence (``SnapshotStore.maybe_save``)
  * journal every epoch/snapshot/restore into the flight recorder
  * catch a crash (any exception out of the epoch -- a raised-mid-epoch
    fault, or the test/benchmark chaos hook's ``SimulatedCrash``) and
    rebuild: fresh loop from the factory, reset with the episode seed,
    then restore, escalating

      newest snapshot -> (integrity failure) -> previous snapshot -> ...
      -> (none valid) -> the ladder's cold start from epoch 0

Because restore is bit-exact (state.snapshot) and all host decisions are
deterministic functions of restored counters, the epochs re-executed after
a resume equal the uninterrupted run's leaf-for-leaf -- recovery costs
wall-clock (``recovery_epochs`` counts the re-executed epochs), not
correctness. Every skipped snapshot is counted (``corrupt_snapshots``).
"""
from __future__ import annotations

import time
from typing import Any, Callable

from repro_torch.state.journal import FlightRecorder
from repro_torch.state.snapshot import SnapshotStore


class SimulatedCrash(RuntimeError):
    """Raised by chaos hooks to kill the loop mid-flight in tests and the
    recovery benchmark -- stands in for a process kill."""


class CrashSupervisor:
    """Drives an OnlineLoop to ``n_epochs`` across crashes.

    factory    () -> OnlineLoop, the *same* configuration every call (the
               snapshot fingerprint enforces this).
    store      SnapshotStore for durability; None disables snapshots (the
               no-checkpoint arm: every crash is a cold start).
    recorder   FlightRecorder journaling the run; optional.
    max_restarts  crash budget before the supervisor re-raises.
    """

    def __init__(self, factory: Callable[[], Any],
                 store: SnapshotStore | None = None,
                 recorder: FlightRecorder | None = None,
                 max_restarts: int = 5):
        self.factory = factory
        self.store = store
        self.recorder = recorder
        self.max_restarts = max_restarts
        self.loop = None
        # recovery accounting (surfaced via metrics())
        self.restarts = 0
        self.cold_restarts = 0
        self.corrupt_snapshots = 0
        self.recovery_epochs = 0       # epochs re-executed after restores
        self.restored_from: list[int] = []
        self.recover_s: list[float] = []  # wall of each recovery: boot + restore

    def _boot(self, seed: int, record_start: bool):
        loop = self.factory()
        if self.recorder is not None:
            loop.attach_recorder(self.recorder)
            if record_start:
                self.recorder.record_start(seed, loop.config_fingerprint())
        loop.reset(seed)
        return loop

    def _recover(self, seed: int, crash_epoch: int):
        """Rebuild after a crash: fresh loop, newest valid snapshot, the
        escalation on integrity failures, cold start at the end."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"crash budget exhausted ({self.max_restarts} restarts)")
        t0 = time.perf_counter()
        loop = self._boot(seed, False)    # reset == the ladder cold start
        restored = 0
        if self.store is not None:
            try:
                restored, skipped = self.store.restore_newest_valid(loop)
                self.corrupt_snapshots += len(skipped)
            except FileNotFoundError:
                # every listed snapshot was tried and failed validation
                self.corrupt_snapshots += len(self.store.epochs())
                self.cold_restarts += 1
        else:
            self.cold_restarts += 1
        self.recovery_epochs += max(crash_epoch - restored, 0)
        self.restored_from.append(restored)
        self.recover_s.append(time.perf_counter() - t0)
        if self.recorder is not None:
            self.recorder.record_restore(crash_epoch, restored)
        return loop

    def run(self, seed: int, n_epochs: int, record: bool = False,
            chaos: Callable[[int], None] | None = None) -> dict:
        """Run episode ``seed`` to ``n_epochs`` completed epochs, surviving
        crashes.

        ``chaos(next_epoch)`` is called before each epoch and may raise to
        simulate a crash (SimulatedCrash or anything else non-exiting).
        The journal's start record carries ``seed`` for replay. With
        record=True the returned metrics carry the run()-compatible
        per-epoch history -- rewound on restore, so re-executed epochs
        appear once."""
        self.loop = loop = self._boot(seed, True)
        hist = loop.history_init()
        while loop.host_epoch < n_epochs:
            try:
                if chaos is not None:
                    chaos(loop.host_epoch + 1)
                out, trigger = loop.step_epoch()
                if record:
                    loop.record_history(hist, out, trigger)
                if self.store is not None:
                    path = self.store.maybe_save(loop)
                    if path is not None and self.recorder is not None:
                        self.recorder.record_snapshot(loop.host_epoch, path)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                crash_epoch = loop.host_epoch
                if self.store is not None:
                    # A real kill would also lose the writer thread; join it
                    # so the restart sees a quiesced directory either way.
                    try:
                        self.store.wait()
                    except Exception:
                        pass
                self.loop = loop = self._recover(seed, crash_epoch)
                if record:
                    for col in hist.values():
                        del col[loop.host_epoch:]
        m = loop.metrics()
        m.update(self.metrics())
        if record:
            m["history"] = hist
        return m

    def metrics(self) -> dict:
        return {
            "restarts": self.restarts,
            "cold_restarts": self.cold_restarts,
            "corrupt_snapshots": self.corrupt_snapshots,
            "supervisor_recovery_epochs": self.recovery_epochs,
            "restored_from": list(self.restored_from),
            "snapshots_saved": self.store.saves if self.store else 0,
        }
