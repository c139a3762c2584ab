"""The port's runtime.ft, a copy of the JAX package's pure-Python module:
the JAX package's tests/test_ft.py cases on it (watchdog semantics,
straggler window, and the narrowed retry allowlist: a bare RuntimeError is
usually the runtime reporting a real device error, so only StepTimeout
plus an explicit allowlist is retried), and the two modules' public
behaviour side by side."""
import time

import pytest

from repro_torch.runtime.ft import (
    StepTimeout,
    StragglerDetector,
    Watchdog,
    run_with_retries,
)


class TestWatchdog:
    def test_fires_after_timeout(self):
        with Watchdog(0.01) as wd:
            time.sleep(0.05)
            assert wd.fired
            with pytest.raises(StepTimeout):
                wd.check()

    def test_cancelled_on_exit(self):
        with Watchdog(0.02) as wd:
            pass
        time.sleep(0.05)             # timer must have been cancelled
        assert not wd.fired

    def test_fired_property_does_not_raise(self):
        # The serving path (faults.degrade.EpochWatchdog) reads `fired`
        # to keep the overrunning epoch's result; only check() raises.
        with Watchdog(0.01) as wd:
            time.sleep(0.05)
            assert wd.fired is True  # no exception
        assert wd.fired is True      # still readable after exit

    def test_fast_step_never_fires(self):
        with Watchdog(5.0) as wd:
            wd.check()
            assert not wd.fired


class TestStragglerDetector:
    def test_needs_window_before_flagging(self):
        det = StragglerDetector()
        # Fewer than 5 samples: even a huge outlier is not flagged.
        for _ in range(4):
            assert not det.record(100.0)
        assert det.straggler_steps == 0

    def test_flags_above_threshold_median(self):
        det = StragglerDetector(threshold=2.0)
        for _ in range(10):
            det.record(1.0)
        assert det.record(3.0)
        assert det.straggler_steps == 1
        assert not det.record(1.5)

    def test_window_slides(self):
        det = StragglerDetector(window=5)
        for _ in range(20):
            det.record(1.0)
        assert len(det.times) == 5


class TestRunWithRetries:
    def test_clean_run(self):
        steps = []
        done, retries, stragglers = run_with_retries(
            steps.append, 5, restore_fn=lambda: 0)
        assert (done, retries) == (5, 0)
        assert steps == [0, 1, 2, 3, 4]

    def test_timeout_is_retried_from_restore_point(self):
        calls = {"n": 0}

        def step(i):
            calls["n"] += 1
            if calls["n"] == 2:
                raise StepTimeout("simulated hang")

        done, retries, _ = run_with_retries(step, 3, restore_fn=lambda: 0)
        assert (done, retries) == (3, 1)
        # step 0, step 1 (hangs), restored: steps 0, 1, 2 again
        assert calls["n"] == 5

    def test_runtime_error_propagates_immediately(self):
        # The narrowed contract: a bare RuntimeError (a compile/OOM/device
        # error) is NOT retried and the restore_fn never runs.
        restored = []

        def step(i):
            raise RuntimeError("CUDA: out of memory")

        with pytest.raises(RuntimeError, match="out of memory"):
            run_with_retries(step, 3, restore_fn=lambda: restored.append(1))
        assert restored == []

    def test_explicit_allowlist_is_retried(self):
        calls = {"n": 0}

        def step(i):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")

        done, retries, _ = run_with_retries(
            step, 2, restore_fn=lambda: 0, retryable=(RuntimeError,))
        assert (done, retries) == (2, 1)

    def test_retry_budget_exhausts_and_raises(self):
        def step(i):
            raise StepTimeout("always hangs")

        with pytest.raises(StepTimeout):
            run_with_retries(step, 2, restore_fn=lambda: 0, max_retries=2)

    def test_allowlist_does_not_widen_to_subclasses_not_listed(self):
        # ValueError is not in the allowlist even when RuntimeError is.
        def step(i):
            raise ValueError("bad operand")

        with pytest.raises(ValueError):
            run_with_retries(step, 2, restore_fn=lambda: 0,
                             retryable=(RuntimeError,))


class _Clock:
    """A stand-in for a module's ``time``: each monotonic() call advances 1 s,
    every 10th call 10 s, so a retry loop sees the same step times (some of
    them stragglers) whatever the host's load."""

    def __init__(self):
        self.calls, self.now = 0, 0.0

    def monotonic(self) -> float:
        self.calls += 1
        self.now += 10.0 if self.calls % 10 == 0 else 1.0
        return self.now


def test_same_behaviour_as_the_reference(monkeypatch):
    """Both modules' detectors flag the same steps and their retry loops
    return the same counts on the same scripted failures and step times."""
    from repro.runtime import ft as jft

    from repro_torch.runtime import ft
    times = [1.0] * 6 + [2.5, 1.0, 3.0, 0.5, 9.0] + [1.0] * 50 + [4.0]
    for threshold, window in ((2.0, 50), (1.5, 5), (3.0, 8)):
        a = ft.StragglerDetector(threshold=threshold, window=window)
        b = jft.StragglerDetector(threshold=threshold, window=window)
        assert [a.record(t) for t in times] == [b.record(t) for t in times]
        assert (a.straggler_steps, a.times) == (b.straggler_steps, b.times)

    def scripted(mod, fail_at):
        monkeypatch.setattr(mod, "time", _Clock())
        calls = {"n": 0}

        def step(i):
            calls["n"] += 1
            if calls["n"] in fail_at:
                raise mod.StepTimeout("scripted")
        return mod.run_with_retries(step, 6, restore_fn=lambda: 2), calls["n"]

    stragglers = 0
    for fail_at in ((), (2,), (1, 4, 7)):
        got = scripted(ft, fail_at)
        assert got == scripted(jft, fail_at)
        stragglers += got[0][2]
    assert stragglers > 0
