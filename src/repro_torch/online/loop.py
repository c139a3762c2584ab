"""The closed loop: streams -> batcher -> telemetry -> QoS -> planner.

One epoch of online serving is one pass of tensor code on the device (the
epoch, ``OnlineLoop._epoch``) plus one host decision point:

  device (tensor code, no host read):
    1. scenario step/env      -- mobility + fading advance, env materializes
    2. faults                 -- outage masks advance, gains are masked
    3. streams                -- per-user Poisson arrivals for the epoch
    4. service model          -- per-user end-to-end seconds under the
                                 *current* plan and the measured edge
                                 congestion (occupancy + backlog inflate the
                                 suffix compute), plus the per-layer
                                 Observation the telemetry folds in
    5. batcher enqueue/admit/tick -- continuous batching; completions out
    6. qos_update             -- percentiles, miss EMAs, trigger bool
    7. telemetry_update       -- measured profile EMA, guarded

  host (per epoch):
    - read the QoS trigger (one scalar, the loop's decision point)
    - on a hardened loop, read the packed health word (one scalar) and let
      the degradation ladder shape the replan
    - OnlineSplitServer.observe(env, prof=measured, force=trigger): replan
      on schedule or on trigger; its one read is the packed plan word

``COUNTS["host_reads"]`` counts the loop's own reads (the trigger and the
health word); ``runtime.serve.COUNTS`` counts the server's plan words and
``core.li_gd.COUNTS`` the solver's stop flags. ``record=True`` adds the
history's reads on top; ``record=False`` adds none. An attached flight
recorder reads the served (health << 16) | s* word once an epoch, counted
apart under ``COUNTS["recorder_reads"]``.

Randomness is counter-based. ``reset(seed)`` derives the scenario, stream
and base seeds as ``fold_in(seed, 0 / 1 / 2)`` (the reference splits its key
in three). Epoch t's draws come from ``fold_in(base, t)``: the stream draws
from it directly, the scenario from ``fold_in(., 1)`` and the faults from
``fold_in(., 2)``, as the reference folds its epoch key. ``epoch_draws(t)``
returns them; ``step_epoch(draws=...)`` takes them, so an episode can run
on any draws of the same structure.

The service model is where the closed loop earns its keep: the edge's
effective speed degrades with load (``1 + load_gain * (occupancy + backlog)
/ capacity``), which the *static* profile cannot see. The telemetry
attributes the inflated suffix times back into effective FLOPs, the
measured profile makes the planner price edge compute honestly, and s*
rises (keep more layers on device) exactly when the edge saturates.

Chaos hardening: fault injection (faults.injectors) runs inside the epoch
with the rates as float32-scalar operands and the persistent outage masks
as one more state; device-side guards (faults.guards) pack every health
check into ONE int32 read per epoch; and the host-side degradation ladder
(faults.degrade) turns that word into reject-and-hold / quarantine /
baseline-fallback / backed-off-cold-replan decisions. A loop constructed
without ``degrade=`` is the unguarded loop.

The SINR backend of the service model (and of the fallback plan's pricing)
is channel's module default (``channel.set_sinr_backend``); the planner's
is the engine's own.

The epoch and the fallback plan are compiled programs (repro_torch.graphs),
the reference's jitted ``online_epoch`` and ``fallback_plan``: on the card
each is a CUDA graph captured on its first call and replayed after, and
compile_log records each once per capture. The draws are made eagerly,
outside the graph, and copied into its static operands with the rest of
the epoch's state; the fault rates are operands too, so set_fault_rates
captures nothing. The epoch counter stays a host int (the draws' counter
and a snapshot's int leaf) and reaches the graph as a float32 device
scalar written each epoch by a fill. What a capture bakes in is the
configuration's Python floats (stream, service, QoS, ladder and compute
constants: fixed for a loop) and the SINR backend, which keys the graph.
A hardened loop builds its fallback program at reset, as the reference
warms it, so an escalation mid-episode captures nothing.

Durable serving (repro_torch.state): ``serving_state()`` is the episode's
complete state as (device tree, JSON host dict), ``load_serving_state``
its inverse on a reset loop, ``state_template(kind)`` the restore-side
validation target and ``config_fingerprint()`` what a snapshot must match.
Since every epoch's draws are a function of (base seed, epoch), a restored
loop's next epochs equal the uninterrupted run's.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.core import channel
from repro_torch.core.types import ModelProfile, SplitPlan, Tensor, lam, make_weights
from repro_torch.core.utility import split_constants
from repro_torch.faults import guards, injectors
from repro_torch.faults.degrade import DegradeLadder, EpochWatchdog, LadderConfig, fallback_plan
from repro_torch.faults.injectors import FaultConfig, FaultState
from repro_torch.online import batcher as batcherlib
from repro_torch.online.batcher import BatchState, ContinuousBatcher
from repro_torch.online.qos import QosConfig, QosMonitor, QosReport, QosState, qos_update
from repro_torch.online.streams import (
    RequestStream,
    StreamConfig,
    StreamState,
    step_draws,
    stream_step_from,
)
from repro_torch.online.telemetry import Observation, Telemetry, TelemetryState, telemetry_update
from repro_torch.planning.engine import plan_state_template
from repro_torch.runtime.serve import OnlineSplitServer
from repro_torch.scenarios.scenario import fold_in

# Host reads of device values made by the loop itself (the QoS trigger and
# the health word), by an attached flight recorder (the served word), and
# fallback plans built, since the last reset_counts().
COUNTS = {"host_reads": 0, "recorder_reads": 0, "fallback_plans": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Edge service knobs. ``edge_capacity`` is the continuous batch size B;
    ``queue_depth`` the admission ring; ``load_gain`` how hard contention
    degrades the edge (effective suffix cost scales by ``1 + load_gain *
    (occupancy + backlog) / capacity``; 0 makes the edge ideal and the
    closed loop converges to the static plan); ``replan_every`` the
    scheduled replan cadence in epochs; ``max_work_epochs`` caps one
    request's slot occupancy."""

    edge_capacity: int = 8
    queue_depth: int = 32
    load_gain: float = 0.0
    replan_every: int = 10
    telemetry_decay: float = 0.9
    max_work_epochs: int = 1000


class EpochOut(NamedTuple):
    """Device-resident per-epoch outputs handed back to the host loop."""

    env: object          # NetworkEnv of the new epoch (the replan operand;
                         # fault-masked gains when injection is active)
    report: QosReport
    counts: Tensor       # (U,) arrivals this epoch
    completed: Tensor    # () int32 completions this epoch
    occupancy: Tensor    # () int32 active slots after the tick
    backlog: Tensor      # () int32 queued requests after the tick
    congestion: Tensor   # () f32 edge slowdown factor used this epoch
    health: Tensor       # () int32 packed health word (faults.guards)
    faulted: Tensor      # () int32 users in deep fade this epoch


def work_epochs(service: Tensor, dt: float, max_work_epochs: int) -> Tensor:
    """Slot epochs of each request, ``ceil(service / dt)`` clipped to
    [1, max_work_epochs], as the reference's saturating float-to-int32 cast
    gives it: NaN counts as 0 (so 1 epoch), +inf and anything from 2^31 up
    as INT32_MAX (so the cap). The value is clamped in floating point before
    the cast, since a float-to-int conversion out of range is undefined in
    PyTorch (on x86 it gives INT32_MIN, which would clip to 1 epoch)."""
    x = torch.ceil(service / dt)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    # 2147483520 is the largest float32 below 2^31.
    w = torch.clamp(x, 1.0, 2147483520.0).to(torch.int32)
    w = torch.where(x >= 2147483648.0, torch.full_like(w, 2147483647), w)
    return torch.clamp(w, 1, int(max_work_epochs))


class OnlineLoop:
    """Closed-loop serving over one time-evolving scenario, on the engine's
    device.

    feedback=True plans against the telemetry's measured profile;
    feedback=False is the open-loop control (static profile), same epochs,
    same traffic: the comparison arm."""

    def __init__(self, scenario, engine, stream_cfg: StreamConfig,
                 service_cfg: ServiceConfig = ServiceConfig(),
                 qos_cfg: QosConfig | None = None,
                 model=None, params=None, feedback: bool = True,
                 faults: FaultConfig | None = None,
                 degrade: LadderConfig | None = None):
        if scenario.device != engine.device:
            raise ValueError(f"the scenario runs on {scenario.device} but the engine on "
                             f"{engine.device}; build both on one device")
        u = scenario.cfg.n_users
        self.device = engine.device
        self.scenario = scenario
        self.engine = engine
        self.stream_cfg = stream_cfg
        self.service_cfg = service_cfg
        self.feedback = bool(feedback)
        # Fault injection (a zero-rate config is an exact identity) and the
        # degradation ladder. ``degrade`` hardens the loop: plan guarding at
        # the server, telemetry quarantine, admission shedding, QoS
        # non-finite guarding, baseline fallback, epoch watchdog.
        self.fault_cfg = faults or FaultConfig()
        self._rates = self.fault_cfg.rates(self.device)
        self.ladder = DegradeLadder(degrade) if degrade is not None else None
        self._hardened = degrade is not None
        ladder_cfg = degrade if degrade is not None else LadderConfig()
        self._kappa_max = float(ladder_cfg.kappa_max)
        self._shed_factor = (float(ladder_cfg.shed_service_factor)
                             if self._hardened else 0.0)
        self._watchdog = (EpochWatchdog(ladder_cfg.watchdog_timeout_s)
                          if self._hardened
                          and ladder_cfg.watchdog_timeout_s > 0 else None)
        self.qos_cfg = qos_cfg or QosConfig(
            deadline_s=stream_cfg.deadline_s,
            guard_nonfinite=self._hardened)
        self.stream = RequestStream(stream_cfg, u, self.device)
        self.batcher = ContinuousBatcher(
            service_cfg.edge_capacity, service_cfg.queue_depth,
            stream_cfg.max_per_user_epoch, self.device)
        self.qos = QosMonitor(self.qos_cfg, u, self.device)
        self.telemetry = Telemetry(engine.prof, scenario.cfg.comp,
                                   service_cfg.telemetry_decay)
        self.server = OnlineSplitServer(engine, model, params,
                                        replan_every=service_cfg.replan_every,
                                        guard_plans=self._hardened)
        # episode state (device tensors), populated by reset()
        self._sc = self._st = self._bt = self._qs = self._tel = None
        self._fs: FaultState | None = None
        self._plan: SplitPlan | None = None
        self._base: int | None = None        # the episode's base seed
        self._plan_template: SplitPlan | None = None   # an engine plan
        self._recorder = None                # a state.FlightRecorder, or None
        self.host_epoch = 0
        # the compiled epoch and fallback plan, and the epoch counter the
        # epoch's graph reads (float32, written by a fill each epoch)
        self.epoch_program = graphs.Compiled("online_epoch", lambda ops: self._epoch(*ops),
                                             self.device)
        self.fallback_program = graphs.Compiled("fallback_plan", self._fallback_body,
                                                self.device)
        self._epoch_at = torch.zeros((), dtype=torch.float32, device=self.device)
        self._fb_weights = (engine.weights if engine.weights is not None
                            else make_weights(u, device=self.device))

    # -- the epoch ------------------------------------------------------------
    def _service_and_observation(self, env, plan: SplitPlan, congestion: Tensor):
        """Per-user modeled service seconds + the telemetry Observation,
        both priced at the *discrete* plan (one-hot subchannels, planned
        powers/compute units) with the measured congestion inflating the
        edge suffix. The static profile is the simulator's ground truth."""
        prof, comp = self.engine.prof, self.scenario.cfg.comp
        s = plan.s
        pre, suf, w_s, m_s = split_constants(prof, s)
        beta_up = F.one_hot(plan.sub_up.long(), env.n_sub).to(env.g_up.dtype)
        beta_dn = F.one_hot(plan.sub_dn.long(), env.n_sub).to(env.g_up.dtype)
        r_up = torch.clamp_min(
            torch.sum(channel.uplink_rates(env, beta_up, plan.p_up), -1), 1e-9)
        r_dn = torch.clamp_min(
            torch.sum(channel.downlink_rates(env, beta_dn, plan.p_dn), -1), 1e-9)
        speed_edge = lam(plan.r, comp) * comp.c_min_edge
        t_dev = pre / comp.c_device
        t_up = w_s / r_up
        t_edge = suf * congestion / speed_edge
        t_dn = m_s / r_dn
        service = t_dev + t_up + t_edge + t_dn                     # (U,)

        f = prof.n_layers
        r_mean = torch.mean(plan.r)
        on_device = torch.arange(f, device=prof.fl.device) < s
        t_layer = torch.where(
            on_device, prof.fl / comp.c_device,
            prof.fl * congestion / (lam(r_mean, comp) * comp.c_min_edge))
        rate_mean = torch.mean(r_up)
        obs = Observation(t_layer=t_layer, t_up=w_s / rate_mean, rate_up=rate_mean,
                          rate_dn=torch.mean(r_dn), r_units=r_mean)
        return service, obs

    @torch.no_grad()
    def _epoch(self, draws: dict, plan: SplitPlan, rates: injectors.FaultRates, sc,
               st: StreamState, bt: BatchState, qs: QosState, tel: TelemetryState,
               fs: FaultState, epoch: Tensor | None = None):
        """One epoch on its draws: pure tensor code, no host read. ``epoch``
        is the stream's epoch counter after this epoch's step (st.epoch + 1)
        as a () float32 device tensor (None: made here by a fill). Returns
        the new (sc, st, bt, qs, tel, fs) and the EpochOut."""
        scen, svc, stream_cfg = self.scenario, self.service_cfg, self.stream_cfg
        dt = stream_cfg.epoch_dt_s
        sc = scen.step_from(draws["scenario"], sc)
        env = scen.env(sc)
        # Faults realize before anything observes the epoch: the masked
        # gains ARE this epoch's channel, for service and replans alike.
        fs, draw = injectors.fault_step_from(rates, draws["fault"], fs)
        env = injectors.apply_env_faults(env, draw, rates)
        st, counts = stream_step_from(stream_cfg, scen.cfg.n_users, draws["stream"], st)
        # Congestion from the load the edge is already carrying when this
        # epoch's work lands.
        load = (batcherlib.occupancy(bt) + batcherlib.backlog(bt)).to(torch.float32)
        congestion = 1.0 + svc.load_gain * load / float(svc.edge_capacity)
        service, obs = self._service_and_observation(env, plan, congestion)
        service = injectors.spike_service(service, draw)
        obs = injectors.corrupt_observation(obs, draw, rates)
        work = work_epochs(service, dt, svc.max_work_epochs)
        if epoch is None:
            epoch = torch.full((), float(st.epoch), dtype=torch.float32, device=self.device)
        now = epoch * dt
        k = stream_cfg.max_per_user_epoch
        shed_thr = self._shed_factor * stream_cfg.deadline_s
        if self._hardened and shed_thr > 0:
            # Admission shedding: a user whose modeled service blows past
            # the deadline by the shed factor (deep fade, AP blackout) would
            # jam a batch slot for max_work_epochs: drop its arrivals (and
            # queued heads, in admit) instead of starving the healthy users
            # behind it.
            doomed = (service > shed_thr) | ~torch.isfinite(service)
            zero = torch.zeros_like(counts)
            shed_n = torch.sum(torch.where(doomed, counts, zero)).to(torch.int32)
            bt = batcherlib.enqueue(bt, torch.where(doomed, zero, counts), now, k)
            bt = bt._replace(shed=bt.shed + shed_n)
            bt = batcherlib.admit(bt, now, service, work, shed=doomed)
        else:
            bt = batcherlib.enqueue(bt, counts, now, k)
            bt = batcherlib.admit(bt, now, service, work)
        bt, comps = batcherlib.tick(bt)
        qs, report = qos_update(self.qos_cfg, qs, comps)
        tel_new = telemetry_update(scen.cfg.comp, svc.telemetry_decay, self.engine.prof.fl,
                                   tel, plan.s, obs)
        obs_word = guards.observation_health(obs)
        if self._hardened:
            # Rung 2, device half: a corrupt observation never enters the
            # EMA; the telemetry state holds, the host-side quarantine
            # decides when to trust the profile again.
            tel = guards.tree_select(obs_word == 0, tel_new, tel)
        else:
            tel = tel_new
        health = guards.pack_health(obs_word, guards.service_health(service),
                                    guards.telemetry_health(tel, self._kappa_max))
        out = EpochOut(env=env, report=report, counts=counts,
                       completed=torch.sum(comps.valid).to(torch.int32),
                       occupancy=batcherlib.occupancy(bt),
                       backlog=batcherlib.backlog(bt),
                       congestion=congestion, health=health,
                       faulted=torch.sum(draw.link_down).to(torch.int32))
        return sc, st, bt, qs, tel, fs, out

    # -- draws ----------------------------------------------------------------
    def _gen(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    @staticmethod
    def seeds(seed: int) -> dict:
        """The episode's scenario, stream and base seeds, from its seed."""
        return {"scenario": fold_in(seed, 0), "stream": fold_in(seed, 1),
                "base": fold_in(seed, 2)}

    def reset_draws(self, seed: int) -> dict:
        """The draws behind reset(seed): the scenario's init draws and the
        stream's initial-session uniforms."""
        s = self.seeds(seed)
        return {"scenario": self.scenario.init_draws(self.scenario.generator(s["scenario"], 0)),
                "stream": self.stream.init_draws(self.stream.generator(s["stream"], 0))}

    def epoch_draws(self, epoch: int) -> dict:
        """Epoch ``epoch``'s draws, a function of (base seed, epoch) alone:
        the scenario step's, the faults' and the stream's."""
        if self._base is None:
            raise RuntimeError("epoch_draws() before reset()")
        k_ep = fold_in(self._base, epoch)
        cfg = self.scenario.cfg
        return {"scenario": self.scenario.step_draws(self._gen(fold_in(k_ep, 1))),
                "fault": injectors.fault_draws(self._gen(fold_in(k_ep, 2)), cfg.n_users,
                                               cfg.n_aps),
                "stream": step_draws(self.stream_cfg, cfg.n_users, self._gen(k_ep))}

    # -- episode driving --------------------------------------------------------
    def set_fault_rates(self, cfg: FaultConfig) -> None:
        """Swap the fault mix mid-episode: the rates are operands of the
        epoch, so this changes nothing else. With a flight recorder
        attached, the swap is journaled (it is host input the deterministic
        replay cannot re-derive)."""
        self.fault_cfg = cfg
        self._rates = cfg.rates(self.device)
        if self._recorder is not None:
            self._recorder.record_rates(self.host_epoch, dataclasses.asdict(cfg))

    def attach_recorder(self, recorder) -> None:
        """Attach a repro_torch.state.FlightRecorder: every epoch's host trace
        (the packed plan/health word, the QoS trigger, the ladder stage)
        and every fault-rate swap are journaled for deterministic replay.
        Recording reads one word an epoch (``COUNTS["recorder_reads"]``);
        pass None to detach."""
        self._recorder = recorder

    def served_word(self, out: EpochOut) -> Tensor:
        """() int32 ``(health << 16) | s*`` of the epoch ``out`` and the plan
        now served: the journal's epoch word, packed on the device."""
        return (out.health.to(torch.int32) << guards.PLAN_WORD_SHIFT) | self._plan.s.to(
            torch.int32)

    def _fallback(self, env) -> SplitPlan:
        """The ladder's rung-3 plan, cast to the engine plan's dtypes, by
        the fallback program."""
        COUNTS["fallback_plans"] += 1
        return self._fallback_plan(env)

    def _fallback_plan(self, env) -> SplitPlan:
        tmpl = self._plan_template
        dtypes = None if tmpl is None else tuple(x.dtype for x in graphs.tensors(tmpl))
        return self.fallback_program(env, key=(channel._SINR_BACKEND, env.radio, env.comp,
                                                dtypes))

    def _fallback_body(self, env) -> SplitPlan:
        return fallback_plan(env, self.engine.prof, self._fb_weights,
                             template=self._plan_template, mode=self.ladder.cfg.fallback)

    def reset(self, seed: int, draws: dict | None = None) -> None:
        """Initialize scenario/stream/batch/QoS/telemetry/fault state and
        take the initial (cold) plan. ``draws`` replaces reset_draws(seed)
        (the base seed still comes from ``seed``). The telemetry starts at
        the static profile, so feedback and static arms are identical until
        load appears."""
        if draws is None:
            draws = self.reset_draws(seed)
        cfg = self.scenario.cfg
        self._base = self.seeds(seed)["base"]
        self.host_epoch = 0
        self._sc = self.scenario.init_from(draws["scenario"])
        self._st = self.stream.init_from(draws["stream"])
        self._bt = self.batcher.init()
        self._qs = self.qos.init()
        self._tel = self.telemetry.init()
        self._fs = injectors.init_fault_state(cfg.n_users, cfg.n_aps, self.device)
        env0 = self.scenario.env(self._sc)
        self.server.observe(env0)          # epoch 0 is always scheduled
        if self.ladder is not None:
            self.ladder.post_replan(self.server.last_plan_ok,
                                    self.server.last_replanned)
        if self.server.state is not None:
            self._plan = self.server.state.plan
            self._plan_template = self._plan
            if self._hardened:
                self._fallback_plan(env0)     # build it now, as the reference warms it
        else:
            # The very first plan was rejected by the guard: serve the
            # baseline fallback until the ladder recovers a real plan.
            self._plan = self._fallback(env0)

    def measured_profile(self) -> ModelProfile:
        """The telemetry's current measured profile (a planner operand)."""
        return self.telemetry.profile(self._tel)

    def epoch_args(self) -> tuple:
        """The epoch's current operands after the draws (post-reset):
        (plan, rates, sc, st, bt, qs, tel, fs)."""
        return (self._plan, self._rates, self._sc, self._st, self._bt, self._qs,
                self._tel, self._fs)

    def _run_epoch(self, draws: dict) -> EpochOut:
        """The epoch program on ``draws`` and the current state; advances
        the state and returns the EpochOut."""
        sc0, st0 = self._sc, self._st
        self._epoch_at.fill_(float(st0.epoch + 1))
        (sc, st, self._bt, self._qs, self._tel, self._fs, out) = self.epoch_program(
            (draws, *self.epoch_args(), self._epoch_at), key=channel._SINR_BACKEND)
        # The host counters advance on the host: a replay returns the
        # capture's ints.
        self._sc = sc._replace(epoch=sc0.epoch + 1)
        self._st = st._replace(epoch=st0.epoch + 1)
        return out

    def _step_epoch_inner(self, draws: dict) -> tuple[EpochOut, bool]:
        out = self._run_epoch(draws)
        trigger = bool(out.report.trigger)   # the per-epoch decision read
        COUNTS["host_reads"] += 1
        if self.ladder is None:
            prof = self.measured_profile() if self.feedback else None
            self.server.observe(out.env, prof=prof, force=trigger)
            self._plan = self.server.state.plan
            return out, trigger
        # Hardened path: one extra scalar (the packed health word) feeds
        # the ladder; the ladder shapes the replan and the served plan.
        health = int(out.health)
        COUNTS["host_reads"] += 1
        dec = self.ladder.pre_replan(health)
        if dec.force_cold:
            self.server.reset_warm()
        prof = (self.measured_profile()
                if self.feedback and dec.use_measured else None)
        self.server.observe(out.env, prof=prof,
                            force=trigger or dec.force, hold=dec.hold)
        self.ladder.post_replan(self.server.last_plan_ok,
                                self.server.last_replanned)
        if self.server.state is None or self.ladder.serve_fallback:
            self._plan = self._fallback(out.env)
        else:
            self._plan = self.server.state.plan
        return out, trigger

    def step_epoch(self, draws: dict | None = None) -> tuple[EpochOut, bool]:
        """One closed-loop epoch on ``draws`` (None: epoch_draws of the
        current epoch). Returns the device-resident EpochOut and whether a
        QoS trigger forced an off-schedule replan (the host-side decision
        read). Hardened loops run under the epoch watchdog: an overrun keeps
        its result (state stays consistent) but escalates the ladder."""
        if self._st is None:
            raise RuntimeError("step_epoch() before reset()")
        if draws is None:
            draws = self.epoch_draws(self._st.epoch)
        if self._watchdog is None:
            out, trigger = self._step_epoch_inner(draws)
        else:
            (out, trigger), fired = self._watchdog.guard(
                lambda: self._step_epoch_inner(draws))
            if fired and self.ladder is not None:
                self.ladder.on_timeout()
        self.host_epoch += 1
        if self._recorder is not None:
            health, s = guards.split_plan_word(int(self.served_word(out)))
            COUNTS["recorder_reads"] += 1
            self._recorder.record_epoch(
                self.host_epoch, s=s, health=health, trigger=trigger,
                stage=self.ladder.stage if self.ladder is not None else "normal")
        return out, trigger

    # -- durable serving (repro_torch.state hooks) -------------------------------
    def _plan_state_template(self, warm: bool, device):
        cfg = self.scenario.cfg
        return plan_state_template(cfg.n_users, cfg.n_aps, cfg.n_sub,
                                   self.engine.prof.n_layers + 1, warm=warm, device=device)

    def serving_state(self) -> tuple[dict, dict]:
        """The loop's complete episode state as ``(device_tree, host)``.

        ``device_tree`` holds every tensor state the epoch and the planner
        thread through epochs (served plan, fault rates, scenario / stream /
        batch / QoS / telemetry / fault state, the server's PlanState and
        GD-iteration accumulator), with the scenario's and the stream's epoch
        counters as int leaves. ``host`` holds the JSON-scalar control-plane
        state (epoch clock, the episode's base seed, server counters, ladder
        state machine). Restoring both via load_serving_state makes the next
        epoch bit-identical to the uninterrupted run's: every epoch's draws
        come from fold_in(base, epoch), and every host decision is a
        deterministic function of the restored counters.

        A server whose first plan was rejected (state None) snapshots a
        zero-filled cold-shaped PlanState with ``plan_state_kind == "none"``,
        so the device treedef stays one of two."""
        if self._st is None:
            raise RuntimeError("serving_state() before reset()")
        if self.server.state is not None:
            ps = self.server.state
            kind = "warm" if ps.warm_rho is not None else "cold"
        else:
            kind = "none"
            ps = self._plan_state_template(False, self.device)
        device = {
            "plan": self._plan, "rates": self._rates,
            "sc": self._sc, "st": self._st, "bt": self._bt, "qs": self._qs,
            "tel": self._tel, "fs": self._fs,
            "server_state": ps, "iters_acc": self.server._iters_acc,
        }
        host = {
            "host_epoch": self.host_epoch,
            "base": self._base,
            "plan_state_kind": kind,
            "server": self.server.export_host(),
            "ladder": (self.ladder.export_state()
                       if self.ladder is not None else None),
        }
        return device, host

    def state_template(self, kind: str) -> dict:
        """serving_state()'s device tree for a snapshot whose PlanState kind
        was ``kind`` ("cold", "warm" or "none"): the live episode tree with
        the engine's PlanState of that kind, built from the shapes alone on
        the meta device -- the restore-side validation target (structure,
        dtypes, shapes)."""
        if kind not in ("cold", "warm", "none"):
            raise ValueError(f"kind must be cold, warm or none, got {kind!r}")
        device, _ = self.serving_state()
        device["server_state"] = self._plan_state_template(kind == "warm", "meta")
        return device

    def load_serving_state(self, device: dict, host: dict) -> None:
        """Overwrite the episode with a restored serving_state(). The loop
        must be reset() first (the configuration and the plan template come
        from reset; the snapshot supplies only state)."""
        if self._st is None:
            raise RuntimeError("load_serving_state() before reset()")
        self._plan = device["plan"]
        self._rates = device["rates"]
        self._sc = device["sc"]
        self._st = device["st"]
        self._bt = device["bt"]
        self._qs = device["qs"]
        self._tel = device["tel"]
        self._fs = device["fs"]
        self._base = int(host["base"])
        self.host_epoch = int(host["host_epoch"])
        self.server.import_host(host["server"], device["iters_acc"])
        self.server.state = (None if host["plan_state_kind"] == "none"
                             else device["server_state"])
        if self.ladder is not None and host["ladder"] is not None:
            self.ladder.import_state(host["ladder"])

    def config_fingerprint(self) -> str:
        """Hash of everything that shapes the epoch and the host policy. A
        snapshot taken under one configuration must not restore into a loop
        built under another; fault *rates* are excluded -- they are operands
        and travel inside the snapshot."""
        parts = repr((self.scenario.cfg, self.stream_cfg, self.service_cfg,
                      self.qos_cfg, self.engine.cfg, self.engine.method,
                      self.engine.rounding, self.engine.warm_rho_min,
                      self.engine.warm_moment_decay,
                      self.ladder.cfg if self.ladder is not None else None,
                      self.feedback))
        return hashlib.sha256(parts.encode()).hexdigest()[:16]

    def run(self, seed: int, n_epochs: int, record: bool = False) -> dict:
        """Drive a fresh episode for ``n_epochs``. With record=True, per-
        epoch scalars are pulled to the host for analysis (benchmark mode);
        record=False reads nothing beyond the loop's decision scalars.
        Returns summary metrics (and, when recording, the trajectory)."""
        self.reset(seed)
        hist = self.history_init()
        for _ in range(n_epochs):
            out, trigger = self.step_epoch()
            if record:
                self.record_history(hist, out, trigger)
        m = self.metrics()
        if record:
            m["history"] = hist
        return m

    def history_init(self) -> dict[str, list]:
        """An empty per-epoch trajectory dict (run()'s record=True columns)."""
        return {k: [] for k in
                ("s", "p50", "p95", "miss_rate", "occupancy", "backlog",
                 "completed", "congestion", "trigger", "health", "faulted",
                 "plan_finite", "stage")}

    def record_history(self, hist: dict[str, list], out: EpochOut,
                       trigger: bool) -> None:
        """Append one epoch's host-visible scalars to ``hist``."""
        hist["s"].append(int(self._plan.s))
        hist["p50"].append(float(out.report.p50))
        hist["p95"].append(float(out.report.p95))
        hist["miss_rate"].append(float(out.report.miss_rate))
        hist["occupancy"].append(int(out.occupancy))
        hist["backlog"].append(int(out.backlog))
        hist["completed"].append(int(out.completed))
        hist["congestion"].append(float(out.congestion))
        hist["trigger"].append(bool(trigger))
        hist["health"].append(int(out.health))
        hist["faulted"].append(int(out.faulted))
        # Was the plan on the air this epoch finite?
        hist["plan_finite"].append(bool(torch.isfinite(self._plan.utility)))
        hist["stage"].append(self.ladder.stage if self.ladder else "normal")

    def metrics(self) -> dict:
        """End-of-episode summary. Reads the episode counters once."""
        m = dict(self.server.metrics())
        m.update({
            "offered": int(self._st.offered),
            "completed": int(self._bt.completed),
            "dropped": int(self._bt.dropped),
            "shed": int(self._bt.shed),
            "served": int(self._qs.served),
            "deadline_missed": int(self._qs.missed),
            "goodput": int(self._qs.good),
            "qos_triggers": int(self._qs.triggers),
            "epochs": int(self._st.epoch),
            "duration_s": float(self._st.epoch) * self.stream_cfg.epoch_dt_s,
        })
        dur = max(m["duration_s"], 1e-9)
        m["requests_per_s"] = m["completed"] / dur
        m["offered_per_s"] = m["offered"] / dur
        m["goodput_per_s"] = m["goodput"] / dur
        if self.ladder is not None:
            m.update(self.ladder.metrics())
        return m
