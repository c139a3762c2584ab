"""The graceful-degradation ladder: host-side policy over device-side guards.

The ladder is the serving loop's decision layer when a guard bit fires.
Its rungs, in escalation order:

  1. reject-and-hold   a replan whose plan fails the health check is never
                       served; the server keeps the last good PlanState
                       (OnlineSplitServer.observe with guard_plans=True).
  2. quarantine        telemetry-health bits freeze the measured-profile
                       feedback: the loop plans against the static
                       ModelProfile until ``quarantine_epochs`` clean
                       observations pass (the device-side gate additionally
                       holds the TelemetryState itself, so corruption
                       never enters the EMA).
  3. baseline fallback after ``baseline_after`` consecutive bad replans
                       the served plan drops to a guaranteed-feasible
                       baseline (device-only / edge-only greedy, from the
                       core.baselines family) while retries continue.
  4. cold replan       degraded-stage retries rebuild the warm state from
                       scratch (the stale warm payload is suspect) on an
                       exponential backoff, so a wedged planner is not
                       hammered every epoch.

All decisions consume only the packed health word and the plan word the
loop already reads: the ladder adds no device traffic. The fallback plan
has the dtypes and shapes of the engine's own SplitPlan (cast against a
template plan when one is given), so the epoch takes either plan alike.

``EpochWatchdog`` generalizes ``runtime.ft.Watchdog`` to the serving path:
detection-only (an epoch that overruns its budget counts and escalates the
ladder instead of raising -- there is no checkpoint to restore mid-epoch).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import (
    EccWeights,
    GdVars,
    ModelProfile,
    NetworkEnv,
    SplitPlan,
)
from repro_torch.faults.guards import TELEMETRY_MASK
from repro_torch.runtime import ft


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Degradation policy knobs. ``shed_service_factor`` > 0 additionally
    sheds arrivals whose modeled service exceeds ``factor * deadline_s`` at
    admission -- under a persistent deep fade those requests would jam
    batch slots for ``max_work_epochs`` each, starving healthy users."""

    quarantine_epochs: int = 20
    baseline_after: int = 3        # consecutive bad replans -> rung 3
    recover_after: int = 1         # consecutive good replans -> normal
    backoff_base: int = 2          # epochs before the first degraded retry
    backoff_max: int = 32
    fallback: str = "device_only"  # rung-3 plan: device_only | edge_only
    kappa_max: float = 100.0       # guards.telemetry_health ceiling
    shed_service_factor: float = 4.0
    watchdog_timeout_s: float = 0.0   # 0 disables the epoch watchdog

    def __post_init__(self) -> None:
        if self.fallback not in ("device_only", "edge_only"):
            raise ValueError(f"unknown fallback mode {self.fallback!r}")
        if self.baseline_after < 1 or self.recover_after < 1:
            raise ValueError("baseline_after/recover_after must be >= 1")


class LadderDecision(NamedTuple):
    """What the loop should do with this epoch's replan opportunity."""

    use_measured: bool   # feed the measured profile (False = quarantined)
    hold: bool           # skip the replan entirely (degraded backoff)
    force: bool          # dispatch off-schedule (degraded retry due)
    force_cold: bool     # rebuild the warm state before dispatching


class DegradeLadder:
    """Host state machine over the per-epoch health/plan words.

    Stages: ``normal`` -> ``hold`` (last good plan served, retries backed
    off) -> ``baseline`` (fallback plan served). Telemetry quarantine is
    orthogonal: it gates the measured-profile operand, not the stage.
    """

    def __init__(self, cfg: LadderConfig = LadderConfig()):
        self.cfg = cfg
        self.stage = "normal"
        self.epoch = 0
        self.quarantine_left = 0
        self.backoff = cfg.backoff_base
        self.cooldown = 0
        self.bad_streak = 0
        self.clean_streak = 0
        self._down_since: int | None = None
        # recovery counters (surfaced via metrics())
        self.quarantines = 0
        self.holds = 0
        self.baseline_fallbacks = 0
        self.cold_replans = 0
        self.recoveries = 0
        self.recovery_epochs: list[int] = []
        self.watchdog_fires = 0

    @property
    def serve_fallback(self) -> bool:
        """Serve the rung-3 baseline plan this epoch? Only while the most
        recent replan attempts are still failing -- one good replan puts
        the planner's plan back on the air even before full recovery."""
        return self.stage == "baseline" and self.bad_streak > 0

    def pre_replan(self, health: int) -> LadderDecision:
        """Fold this epoch's health word in; decide the replan posture."""
        self.epoch += 1
        if health & TELEMETRY_MASK:
            if self.quarantine_left == 0:
                self.quarantines += 1
            self.quarantine_left = self.cfg.quarantine_epochs
        elif self.quarantine_left > 0:
            self.quarantine_left -= 1
        use_measured = self.quarantine_left == 0
        if self.stage == "normal":
            return LadderDecision(use_measured, hold=False, force=False,
                                  force_cold=False)
        self.cooldown -= 1
        if self.cooldown <= 0:
            self.cold_replans += 1
            return LadderDecision(use_measured, hold=False, force=True,
                                  force_cold=True)
        return LadderDecision(use_measured, hold=True, force=False,
                              force_cold=False)

    def post_replan(self, plan_ok: bool | None, replanned: bool) -> None:
        """Fold the replan outcome in: escalate on a rejected plan, recover
        on clean ones. Held epochs (no dispatch) carry no evidence."""
        if not replanned or plan_ok is None:
            return
        if plan_ok:
            self.clean_streak += 1
            self.bad_streak = 0
            if (self.stage != "normal"
                    and self.clean_streak >= self.cfg.recover_after):
                self.stage = "normal"
                self.recoveries += 1
                if self._down_since is not None:
                    self.recovery_epochs.append(self.epoch - self._down_since)
                    self._down_since = None
                self.backoff = self.cfg.backoff_base
                self.cooldown = 0
            return
        self.clean_streak = 0
        self.bad_streak += 1
        if self._down_since is None:
            self._down_since = self.epoch
        if self.stage == "normal":
            self.stage = "hold"
            self.holds += 1
        elif (self.stage == "hold"
              and self.bad_streak >= self.cfg.baseline_after):
            self.stage = "baseline"
            self.baseline_fallbacks += 1
        self.cooldown = self.backoff
        self.backoff = min(self.backoff * 2, self.cfg.backoff_max)

    def on_timeout(self) -> None:
        """An epoch overran the watchdog budget: count it and back the
        planner off as if a replan had failed (no plan evidence, but a
        wedged epoch is not the moment to dispatch more work)."""
        self.watchdog_fires += 1
        if self.stage == "normal":
            self.stage = "hold"
            self.holds += 1
            if self._down_since is None:
                self._down_since = self.epoch
        self.cooldown = self.backoff
        self.backoff = min(self.backoff * 2, self.cfg.backoff_max)

    def export_state(self) -> dict:
        """The ladder's full host state as JSON-serializable scalars, for
        a serving snapshot. ``_down_since`` rides along so
        an outage that spans a crash keeps its original start epoch --
        recovery latency is measured once, from the true onset, and never
        double-counted across a restore."""
        return {
            "stage": self.stage,
            "epoch": self.epoch,
            "quarantine_left": self.quarantine_left,
            "backoff": self.backoff,
            "cooldown": self.cooldown,
            "bad_streak": self.bad_streak,
            "clean_streak": self.clean_streak,
            "down_since": self._down_since,
            "quarantines": self.quarantines,
            "holds": self.holds,
            "baseline_fallbacks": self.baseline_fallbacks,
            "cold_replans": self.cold_replans,
            "recoveries": self.recoveries,
            "recovery_epochs": list(self.recovery_epochs),
            "watchdog_fires": self.watchdog_fires,
        }

    def import_state(self, state: dict) -> None:
        """Inverse of export_state: overwrite the ladder with a snapshot."""
        self.stage = str(state["stage"])
        self.epoch = int(state["epoch"])
        self.quarantine_left = int(state["quarantine_left"])
        self.backoff = int(state["backoff"])
        self.cooldown = int(state["cooldown"])
        self.bad_streak = int(state["bad_streak"])
        self.clean_streak = int(state["clean_streak"])
        ds = state["down_since"]
        self._down_since = None if ds is None else int(ds)
        self.quarantines = int(state["quarantines"])
        self.holds = int(state["holds"])
        self.baseline_fallbacks = int(state["baseline_fallbacks"])
        self.cold_replans = int(state["cold_replans"])
        self.recoveries = int(state["recoveries"])
        self.recovery_epochs = [int(x) for x in state["recovery_epochs"]]
        self.watchdog_fires = int(state["watchdog_fires"])

    def metrics(self) -> dict:
        mean_rec = (sum(self.recovery_epochs) / len(self.recovery_epochs)
                    if self.recovery_epochs else 0.0)
        return {
            "ladder_stage": self.stage,
            "quarantines": self.quarantines,
            "quarantine_left": self.quarantine_left,
            "holds": self.holds,
            "baseline_fallbacks": self.baseline_fallbacks,
            "ladder_cold_replans": self.cold_replans,
            "recoveries": self.recoveries,
            "mean_recovery_epochs": mean_rec,
            "watchdog_fires": self.watchdog_fires,
        }


class EpochWatchdog:
    """Detection-only watchdog for the serving loop, generalizing
    ``ft.Watchdog`` from the training path: the epoch's host-side critical
    section runs under a timer, and an overrun *reports* instead of
    raising -- the epoch's result is kept (state stays consistent) and the
    ladder escalates via ``on_timeout``. A zero timeout disables it."""

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self.fires = 0

    def guard(self, fn: Callable):
        """Run ``fn`` under the timer; returns (result, fired)."""
        if self.timeout_s <= 0:
            return fn(), False
        with ft.Watchdog(self.timeout_s) as wd:
            out = fn()
        fired = wd.fired
        self.fires += int(fired)
        return out, fired


def fallback_plan(env: NetworkEnv, prof: ModelProfile, w: EccWeights,
                  template: SplitPlan | None = None,
                  mode: str = "device_only") -> SplitPlan:
    """A guaranteed-feasible SplitPlan from the core.baselines family.

    ``device_only`` keeps every layer local (s = F, minimum radio/edge
    footprint): finite under ANY channel state, including a full AP
    blackout: the terminal rung. ``edge_only`` is the greedy full-offload
    twin (max power, best own-gain subchannel, full edge allocation) for
    deployments whose devices cannot run the model.

    Pure and on the device. Its leaves have the dtypes and shapes of the
    engine's plans (s, subchannels and iteration counts int32, the rest
    float32); when ``template`` (any engine-produced plan) is given, every
    leaf is cast to the template's dtype as well. The utility is priced
    through channel.user_rates with the module's SINR backend.
    """
    from repro_torch.core.utility import delay_energy  # deferred: keep the
    # faults package importable without the solver stack

    if mode not in ("device_only", "edge_only"):
        raise ValueError(f"unknown fallback mode {mode!r}")
    u, f = env.n_users, prof.n_layers
    rc, cc = env.radio, env.comp
    dev = env.g_up.device
    best_up = torch.argmax(env.own_gain_up(), dim=-1).to(torch.int32)
    best_dn = torch.argmax(env.own_gain_dn(), dim=-1).to(torch.int32)

    def full(x: float) -> torch.Tensor:
        return torch.full((u,), x, dtype=torch.float32, device=dev)

    if mode == "device_only":
        s = f
        p_up, p_dn, r = full(rc.p_up_min_w), full(rc.p_dn_min_w), full(cc.r_min)
    else:
        s = 0
        p_up, p_dn, r = full(rc.p_up_max_w), full(rc.p_dn_max_w), full(cc.r_max)
    v = GdVars(beta_up=F.one_hot(best_up.long(), env.n_sub).to(torch.float32),
               beta_dn=F.one_hot(best_dn.long(), env.n_sub).to(torch.float32),
               p_up=p_up, p_dn=p_dn, r=r)
    t_cost, e_cost = delay_energy(env, prof, s, v)
    util = torch.sum(w.w_T * t_cost + w.w_E * e_cost).to(torch.float32)
    plan = SplitPlan(
        s=torch.full((), s, dtype=torch.int32, device=dev), sub_up=best_up,
        sub_dn=best_dn, p_up=p_up, p_dn=p_dn, r=r, utility=util,
        per_layer_utility=util.expand(f + 1).clone(),
        iters=torch.zeros((f + 1,), dtype=torch.int32, device=dev),
        rounding_violations=torch.zeros((), dtype=torch.int32, device=dev))
    if template is not None:
        plan = SplitPlan(**{fld.name: getattr(plan, fld.name).to(getattr(template, fld.name).dtype)
                            for fld in dataclasses.fields(SplitPlan)})
    return plan
