"""The port's closed OnlineLoop against the JAX package's, epoch by epoch,
on the CPU; the chaos configuration's episodes and the carry-across are in
test_torch_chaos_loop.py, the model batchers in test_torch_decode_batcher.py.

The reference episode runs first and records, after reset and after every
epoch, its draws (the epoch key folded and split as the reference does:
the stream's Poisson counts and uniforms from fold_in(base, t), the
scenario's from fold_in(., 1), the faults' seven uniforms from
fold_in(., 2)) and its state. The port's loop is fed those draws
(reset(seed, draws=...), step_epoch(draws)) and held, after every epoch, to:
  * equal discrete outputs: the served s*, the arrivals, completions,
    occupancy, backlog, faulted users, health word, QoS trigger, ladder
    state (export_state()), the server's counters (export_host()), and the
    per-split GD iterations of every replan;
  * the QoS report, the congestion, and the batch, QoS, telemetry, fault
    and stream states within 1e-5 of each element's magnitude (float32
    rates and sums in another order; NaN where the reference has NaN);
  * the served plan, a GD output, to the engine's parity bound
    (tests/test_torch_engine.py, after the reference's own backend test):
    powers and compute units to rtol 1e-3 / atol 1e-4, the utilities to
    rtol 1e-4 (measured: 1.5e-4 of 0.1 W on p_dn, 3.2e-6 on the
    utilities);
  * equal metrics() at the end.

Episodes run in lock-step: after the reset's plan and after every replan
the reference's PlanState and served plan are carried into the port. Run
free, a warm replan chain is a knife edge of the reference itself (ROADMAP
section 3): the port's warm state after a replan differs from the
reference's by up to 2.7e-5 of its magnitude (float32 sums in another
order), and from a state that close the reference's own replan stops
splits after other steps (loaded, epoch 9 of seed 0: split 3 after 9 steps
from its own state, 12 from the port's) or, where a split runs to
max_iters without settling, ends at powers up to 2.8e-3 apart (chaos,
epoch 11 of seed 7). The reference fed the port's state gives the port's
result. A lock-step replan whose iterations still differ (once, on the
kernel backend) is held to the reference's replan on gains scaled by
1 +- 1e-7 or 1 +- 3e-7 whose iterations it has, as test_torch_fleet.py
does. The free-running episodes (free_run) hold every discrete output and
each replan against the reference's replan on the port's own inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import GdConfig, channel, li_gd, profiles  # noqa: E402
from repro_torch.faults import FaultConfig, LadderConfig  # noqa: E402
from repro_torch.online import OnlineLoop, ServiceConfig, StreamConfig  # noqa: E402
from repro_torch.online import loop as looplib  # noqa: E402
from repro_torch.planning import PlannerEngine  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402
from repro_torch.scenarios import Scenario, ScenarioConfig  # noqa: E402

RTOL = 1e-5
# The served plan's floats: tests/test_torch_engine.py's bound (rtol, atol).
PLAN_TOL = {"p_up": (1e-3, 1e-4), "p_dn": (1e-3, 1e-4), "r": (1e-3, 1e-4),
            "utility": (1e-4, 0.0), "per_layer_utility": (1e-4, 0.0)}
# tests/test_online_loop.py and tests/test_faults.py
LOADED = dict(scen=dict(n_users=8, n_aps=2, n_sub=3, fading_rho=0.95),
              stream=dict(arrival_rate_hz=30.0, epoch_dt_s=0.02, deadline_s=0.2),
              service=dict(edge_capacity=4, queue_depth=32, load_gain=8.0, replan_every=5),
              gd=dict(step_size=3e-2, eps=1e-4, max_iters=60, optimizer="adam"),
              faults=None, degrade=None, feedback=True)
CHAOS_FAULTS = dict(link_outage_rate=0.2, fade_depth=1e-6, ap_outage_rate=0.05,
                    telemetry_drop_rate=0.1, telemetry_spike_rate=0.05,
                    service_spike_rate=0.02)
CHAOS = dict(scen=dict(n_users=6, n_aps=2, n_sub=3, fading_rho=0.95),
             stream=dict(arrival_rate_hz=25.0, epoch_dt_s=0.02, deadline_s=0.2),
             service=dict(edge_capacity=4, queue_depth=16, load_gain=4.0, replan_every=3,
                          max_work_epochs=200),
             gd=dict(step_size=3e-2, eps=1e-4, max_iters=40, optimizer="adam"),
             faults=CHAOS_FAULTS, degrade={}, feedback=True)
STATES = ("bt", "qs", "tel", "fs")
FAULT_KEYS = ("link_fail", "link_recover", "ap_fail", "ap_recover", "tel_drop", "tel_spike",
              "svc_spike")


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(tree):
    """A NamedTuple or dataclass of arrays as a dict of numpy arrays."""
    if dataclasses.is_dataclass(tree):
        return {f.name: np.asarray(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


# -- the reference's draws -----------------------------------------------------
def _pair(jax, key, shape):
    kr, ki = jax.random.split(key)
    return _t(jax.random.normal(kr, shape)), _t(jax.random.normal(ki, shape))


def _init_draws(jax, key, cfg):
    """JAX's draws behind Scenario.init(key) (tests/test_torch_scenarios.py)."""
    k_ap, k_pos, k_wp, k_up, k_dn = jax.random.split(key, 5)
    k_u = jax.random.split(k_pos, 4)[0]
    assert cfg.cluster_frac == 0.0
    shape = (cfg.n_users, cfg.n_aps, cfg.n_sub)
    return {"ap_pos": _t(jax.random.uniform(k_ap, (cfg.n_aps, 2))),
            "pos": {"uniform": _t(jax.random.uniform(k_u, (cfg.n_users, 2)))},
            "waypoint": _t(jax.random.uniform(k_wp, (cfg.n_users, 2))),
            "h_up": _pair(jax, k_up, shape), "h_dn": _pair(jax, k_dn, shape)}


def _step_draws(jax, key, cfg):
    """JAX's draws behind Scenario.step(key, state), without churn."""
    k_mob, k_up, k_dn, _, _ = jax.random.split(key, 5)
    assert cfg.arrival_rate_hz == 0.0
    shape = (cfg.n_users, cfg.n_aps, cfg.n_sub)
    return {"waypoint": _t(jax.random.uniform(k_mob, (cfg.n_users, 2))),
            "h_up": _pair(jax, k_up, shape), "h_dn": _pair(jax, k_dn, shape)}


def ref_reset_draws(jax, key, scen_cfg):
    """(reset draws, base key) of the reference's OnlineLoop.reset(key)."""
    k_sc, k_st, base = jax.random.split(key, 3)
    return {"scenario": _init_draws(jax, k_sc, scen_cfg),
            "stream": _t(jax.random.uniform(k_st, (scen_cfg.n_users,)))}, base


def ref_epoch_draws(jax, base, epoch, scen_cfg, stream_cfg):
    """The draws of the reference's epoch ``epoch``, keyed as the port's
    OnlineLoop.epoch_draws keys its own."""
    u, n = scen_cfg.n_users, scen_cfg.n_aps
    k_ep = jax.random.fold_in(base, epoch)
    k_arr, k_churn, k_fresh = jax.random.split(k_ep, 3)
    lam = stream_cfg.arrival_rate_hz * stream_cfg.epoch_dt_s
    stream = {"counts": _t(jax.random.poisson(k_arr, lam, (u,), dtype=jax.numpy.int32))}
    if stream_cfg.session_churn_hz > 0.0:
        stream["churn"] = _t(jax.random.uniform(k_churn, (u,)))
        stream["fresh"] = _t(jax.random.uniform(k_fresh, (u,)))
    dims = {"link_fail": (u,), "link_recover": (u,), "ap_fail": (n,), "ap_recover": (n,),
            "tel_drop": (), "tel_spike": (), "svc_spike": (u,)}
    keys = jax.random.split(jax.random.fold_in(k_ep, 2), 7)
    return {"scenario": _step_draws(jax, jax.random.fold_in(k_ep, 1), scen_cfg),
            "fault": {k: _t(jax.random.uniform(kk, dims[k])) for k, kk in zip(FAULT_KEYS, keys)},
            "stream": stream}


# -- recording and comparing --------------------------------------------------------
def _record(loop, out=None, trigger=None) -> dict:
    """Everything the comparison reads, as numpy / Python values (works on
    either package's loop)."""
    rec = {"plan": _np(loop._plan), "server": loop.server.export_host(),
           "ladder": loop.ladder.export_state() if loop.ladder is not None else None,
           "st": {"session": np.asarray(loop._st.session), "epoch": int(loop._st.epoch),
                  "offered": int(loop._st.offered)}}
    for name in STATES:
        rec[name] = _np(getattr(loop, "_" + name))
    if loop.server.last_replanned and loop.server.state is not None:
        rec["iters"] = np.asarray(loop.server.state.plan.iters).tolist()
    if out is not None:
        rec.update(trigger=bool(trigger), report=_np(out.report),
                   **{k: np.asarray(getattr(out, k)) for k in
                      ("counts", "completed", "occupancy", "backlog", "congestion", "health",
                       "faulted")})
    return rec


def _to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what, rtol=RTOL, atol=0.0):
    got, want = _to_np(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    got, want = got.astype(np.float64), want.astype(np.float64)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(got - want))
    scale = np.maximum(np.abs(got), np.abs(want))
    assert np.all(same | (err <= rtol * scale + atol)), (what, got, want)


def check_epoch(got: dict, want: dict, where: str) -> None:
    """Hold a port record to the reference's."""
    for key in ("server", "ladder", "iters", "trigger"):
        assert got.get(key) == want.get(key), (where, key, got.get(key), want.get(key))
    for key in ("counts", "completed", "occupancy", "backlog", "health", "faulted"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{where} {key}")
    for key in ("congestion",):
        if key in want:
            _close(got[key], want[key], f"{where} {key}")
    assert (got["st"]["epoch"], got["st"]["offered"]) == (want["st"]["epoch"],
                                                          want["st"]["offered"]), where
    np.testing.assert_array_equal(got["st"]["session"], want["st"]["session"])
    for k, v in want["plan"].items():
        _close(got["plan"][k], v, f"{where} plan.{k}", *PLAN_TOL.get(k, (RTOL, 0.0)))
    for group in ("report",) + STATES:
        if group in want:
            for k, v in want[group].items():
                _close(got[group][k], v, f"{where} {group}.{k}")


# -- building the two loops ------------------------------------------------------------
def port_loop(cfg: dict, backend: str = "einsum") -> OnlineLoop:
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(**cfg["gd"]), sinr_backend=backend,
                        device="cpu")
    return OnlineLoop(Scenario(ScenarioConfig(**cfg["scen"]), device="cpu"), eng,
                      StreamConfig(**cfg["stream"]), ServiceConfig(**cfg["service"]),
                      feedback=cfg["feedback"],
                      faults=None if cfg["faults"] is None else FaultConfig(**cfg["faults"]),
                      degrade=None if cfg["degrade"] is None else LadderConfig(**cfg["degrade"]))


def _replan_inputs(loop, prev, cold_before: int):
    """(warm state, profile) that the loop's replan of this epoch ran on:
    None for a state the ladder dropped (a cold retry), the measured
    profile unless feedback is off or the telemetry is quarantined."""
    lad = loop.ladder
    if lad is not None and lad.cold_replans > cold_before:
        prev = None
    measured = loop.feedback and (lad is None or lad.quarantine_left == 0)
    return prev, loop.measured_profile() if measured else None


def _cold_count(loop) -> int:
    return loop.ladder.cold_replans if loop.ladder is not None else 0


def _carry_np(loop, rec) -> dict:
    ps = loop.server.state
    return {"state": None if ps is None else _plan_state_np(ps), "plan": rec["plan"]}


def ref_episode(jx: dict, cfg: dict, n_epochs: int, seed: int = 0, swap=None,
                snapshot_at: int | None = None, snapshot=None) -> dict:
    """Run the reference's OnlineLoop; record its draws and, after reset and
    every epoch, its state, and after each replan what lock-step carries
    (its PlanState and served plan) and a rerun of the replan on scaled
    gains. ``swap`` = (epoch, FaultConfig kwargs) swaps the fault rates
    before that epoch; ``snapshot(loop)`` is recorded before epoch
    ``snapshot_at``."""
    jax = jx["jax"]
    j = jx["mods"]
    loop = j["OnlineLoop"](
        j["Scenario"](j["ScenarioConfig"](**cfg["scen"])),
        j["PlannerEngine"](j["profiles"].nin(), cfg=j["GdConfig"](**cfg["gd"])),
        j["StreamConfig"](**cfg["stream"]), j["ServiceConfig"](**cfg["service"]),
        feedback=cfg["feedback"],
        faults=None if cfg["faults"] is None else j["FaultConfig"](**cfg["faults"]),
        degrade=None if cfg["degrade"] is None else j["LadderConfig"](**cfg["degrade"]))
    key = jax.random.PRNGKey(seed)
    loop.reset(key)
    reset_draws, base = ref_reset_draws(jax, key, loop.scenario.cfg)
    rec0 = _record(loop)
    ep = {"seed": seed, "reset_draws": reset_draws, "reset": rec0, "epochs": [],
          "reset_carry": _carry_np(loop, rec0)}
    for t in range(n_epochs):
        if swap is not None and t == swap[0]:
            loop.set_fault_rates(j["FaultConfig"](**swap[1]))
        if snapshot_at == t:
            ep["snapshot"] = snapshot(loop)
        draws = ref_epoch_draws(jax, base, t, loop.scenario.cfg, loop.stream_cfg)
        prev, cold = loop.server.state, _cold_count(loop)
        out, trigger = loop.step_epoch()
        rec = _record(loop, out, trigger)
        rec["draws"] = draws
        rec["plan_finite"] = bool(np.isfinite(np.asarray(loop._plan.utility)))
        if loop.server.last_replanned:
            rec["carry"] = _carry_np(loop, rec)
            warm, prof = _replan_inputs(loop, prev, cold)
            rec["replan"] = lambda f, warm=warm, env=out.env, prof=prof: loop.engine.replan(
                warm, dataclasses.replace(env, g_up=env.g_up * f, g_dn=env.g_dn * f), prof=prof)
        ep["epochs"].append(rec)
    ep["metrics"] = loop.metrics()
    return ep


def _plan_state_np(ps) -> dict:
    return {"plan": _np(ps.plan), "norms": {k: np.asarray(v) for k, v in ps.norms.items()},
            "moms": None if ps.moms is None else
            tuple({k: np.asarray(v) for k, v in m.items()} for m in ps.moms),
            "opt_steps": None if ps.opt_steps is None else np.asarray(ps.opt_steps),
            "gains": None if ps.gains is None else np.asarray(ps.gains),
            "total_iters": np.asarray(ps.total_iters),
            "warm_rho": None if ps.warm_rho is None else np.asarray(ps.warm_rho)}


def port_plan_state(d: dict):
    ps = convert.plan_state_from_numpy(d["norms"], d["moms"], d["opt_steps"], d["gains"],
                                       device="cpu")
    return dataclasses.replace(
        ps, plan=convert.split_plan_from_numpy(**d["plan"], device="cpu"),
        total_iters=convert.tensor(d["total_iters"], "cpu"),
        warm_rho=None if d["warm_rho"] is None else convert.tensor(d["warm_rho"], "cpu"))


def carry(loop: OnlineLoop, c: dict) -> None:
    """Carry the reference's server PlanState and served plan into the port."""
    loop.server.state = None if c["state"] is None else port_plan_state(c["state"])
    loop._plan = convert.split_plan_from_numpy(**c["plan"], device="cpu")


# Gain scalings of the reference's perturbed replans (ROADMAP section 3).
PERTURBATIONS = (1 - 1e-7, 1 + 1e-7, 1 - 3e-7, 1 + 3e-7)


def run_port(loop: OnlineLoop, ep: dict, epochs=None, lock_step: bool = True, swap=None,
             start: int = 0) -> int:
    """Drive the port's loop on the reference episode's draws and hold it
    to the reference after every epoch (check_epoch). ``lock_step`` carries
    the reference's PlanState and served plan into the port after each
    replan, and holds a replan whose per-split iterations differ from the
    reference's to the reference's replan on gains scaled by one of
    PERTURBATIONS, the one whose iterations it has. Returns the number of
    such replans."""
    recs = ep["epochs"] if epochs is None else epochs
    moved = 0
    for t, want in enumerate(recs, start):
        if swap is not None and t == swap[0]:
            loop.set_fault_rates(FaultConfig(**swap[1]))
        out, trigger = loop.step_epoch(want["draws"])
        got = _record(loop, out, trigger)
        if lock_step and "replan" in want and got.get("iters") != want.get("iters"):
            runs = [want["replan"](f) for f in PERTURBATIONS]
            iters = [np.asarray(r.plan.iters).tolist() for r in runs]
            assert got["iters"] in iters, (t, got["iters"], want["iters"], iters)
            match = runs[iters.index(got["iters"])].plan
            want = dict(want, iters=got["iters"], plan=_np(match),
                        server=dict(want["server"], split_layer=int(match.s)))
            moved += 1
        check_epoch(got, want, f"epoch {t}")
        if lock_step and "carry" in want:
            carry(loop, want["carry"])
    return moved


def metrics_equal(got: dict, want: dict, moved: int) -> None:
    """Equal metrics; with perturbation-matched replans, the GD-iteration
    total is the port's own."""
    got, want = dict(got), dict(want)
    if moved:
        got.pop("total_iters")
        want.pop("total_iters")
    assert got == want


def _jax_inputs(jnp, j, warm, env, prof):
    """The port's replan inputs as the reference's: PlanState, NetworkEnv,
    ModelProfile."""
    from repro.core.types import ComputeConstants, NetworkEnv, RadioConstants
    from repro.planning.engine import PlanState

    def arr(x):
        return jnp.asarray(x.numpy())
    jwarm = None if warm is None else PlanState(
        plan=None, norms={k: arr(v) for k, v in warm.norms.items()}, total_iters=None,
        moms=tuple({k: arr(v) for k, v in m.items()} for m in warm.moms),
        opt_steps=arr(warm.opt_steps), gains=arr(warm.gains))
    jenv = NetworkEnv(g_up=arr(env.g_up), g_dn=arr(env.g_dn), ap=arr(env.ap),
                      radio=RadioConstants(**dataclasses.asdict(env.radio)),
                      comp=ComputeConstants(**dataclasses.asdict(env.comp)))
    jprof = None if prof is None else j["profiles"].nin().like(arr(prof.fl), arr(prof.w),
                                                                 arr(prof.m_down))
    return jwarm, jenv, jprof


def free_run(jx: dict, cfg: dict, loop: OnlineLoop, ep: dict, swap=None) -> tuple:
    """Run the port free on the reference episode's draws: its discrete
    outputs (arrivals, completions, occupancy, backlog, health, faulted,
    trigger, server counters, ladder state) equal the reference's after
    every epoch. At each replan whose plan it kept, the reference's replan
    on the port's own inputs (warm state, masked env and profile, carried
    across) is rerun on the gains and on PERTURBATIONS of them: where the
    reference's iterations hold under the scalings, the port's iterations
    equal them and its plan is within the plan bound; where they do not (a
    knife edge of the reference itself), the port's s* is among the
    reference's. Returns (replans held strictly, knife edges, replans whose
    iterations differ from the reference episode's)."""
    jnp, j = jx["jax"].numpy, jx["mods"]
    jeng = j["PlannerEngine"](j["profiles"].nin(), cfg=j["GdConfig"](**cfg["gd"]))
    strict = knife = differ = 0
    for t, want in enumerate(ep["epochs"]):
        if swap is not None and t == swap[0]:
            loop.set_fault_rates(FaultConfig(**swap[1]))
        prev, cold = loop.server.state, _cold_count(loop)
        out, trigger = loop.step_epoch(want["draws"])
        got = _record(loop, out, trigger)
        for key in ("counts", "completed", "occupancy", "backlog", "health", "faulted"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"epoch {t} {key}")
        for key in ("trigger", "server", "ladder"):
            assert got[key] == want[key], (t, key, got[key], want[key])
        if not (loop.server.last_replanned and loop.server.last_plan_ok):
            continue
        differ += got["iters"] != want["iters"]
        warm, prof = _replan_inputs(loop, prev, cold)
        jwarm, jenv, jprof = _jax_inputs(jnp, j, warm, out.env, prof)
        runs = [jeng.replan(jwarm, dataclasses.replace(jenv, g_up=jenv.g_up * f,
                                                       g_dn=jenv.g_dn * f), prof=jprof)
                for f in (1.0,) + PERTURBATIONS]
        iters = [np.asarray(r.plan.iters).tolist() for r in runs]
        plan = loop.server.state.plan
        if iters.count(iters[0]) == len(iters):
            assert got["iters"] == iters[0], (t, got["iters"], iters)
            for k, v in _np(runs[0].plan).items():
                _close(getattr(plan, k), v, f"epoch {t} replan.{k}",
                       *PLAN_TOL.get(k, (RTOL, 0.0)))
            strict += 1
        else:
            assert int(plan.s) in [int(r.plan.s) for r in runs], (t, iters)
            knife += 1
    return strict, knife, differ


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from repro.core import profiles as jprofiles
    from repro.core.types import GdConfig as JGdConfig
    from repro.faults import FaultConfig as JFaultConfig
    from repro.faults import LadderConfig as JLadderConfig
    from repro.online import OnlineLoop as JOnlineLoop
    from repro.online import ServiceConfig as JServiceConfig
    from repro.online import StreamConfig as JStreamConfig
    from repro.planning import PlannerEngine as JPlannerEngine
    from repro.scenarios import Scenario as JScenario
    from repro.scenarios import ScenarioConfig as JScenarioConfig
    mods = dict(profiles=jprofiles, GdConfig=JGdConfig, FaultConfig=JFaultConfig,
                LadderConfig=JLadderConfig, OnlineLoop=JOnlineLoop, ServiceConfig=JServiceConfig,
                StreamConfig=JStreamConfig, PlannerEngine=JPlannerEngine, Scenario=JScenario,
                ScenarioConfig=JScenarioConfig)
    return dict(jax=jax, mods=mods)


@pytest.fixture(scope="module")
def loaded_episode(jx):
    return ref_episode(jx, LOADED, 24)


@pytest.fixture(scope="module")
def static_episode(jx):
    """The open-loop arm: the same traffic planned on the static profile."""
    return ref_episode(jx, dict(LOADED, feedback=False), 12)


# -- the loaded, fault-free loop against the reference ----------------------------------
@pytest.mark.parametrize("backend", ["einsum", "kernel"])
def test_loaded_episode_matches_reference(loaded_episode, backend):
    """24 epochs of the loaded loop (feedback on, no faults, no ladder) in
    lock-step, on both SINR backends (service model and planner): equal
    discrete outputs and iterations, floats within their bounds, equal
    metrics."""
    prev = channel.set_sinr_backend(backend)
    try:
        loop = port_loop(LOADED, backend)
        loop.reset(0, draws=loaded_episode["reset_draws"])
        check_epoch(_record(loop), loaded_episode["reset"], "reset")
        carry(loop, loaded_episode["reset_carry"])
        moved = run_port(loop, loaded_episode)
        metrics_equal(loop.metrics(), loaded_episode["metrics"], moved)
        assert moved <= 1
    finally:
        channel.set_sinr_backend(prev)
    hist = [e["server"]["split_layer"] for e in loaded_episode["epochs"]]
    assert len(set(hist)) > 1                        # s* moved under load
    assert sum(e["trigger"] for e in loaded_episode["epochs"]) >= 1


def test_static_arm_matches_reference(static_episode):
    """The open-loop comparison arm (feedback=False): 12 epochs in lock-step
    on the loaded configuration's traffic, einsum backend."""
    loop = port_loop(dict(LOADED, feedback=False))
    loop.reset(0, draws=static_episode["reset_draws"])
    check_epoch(_record(loop), static_episode["reset"], "reset")
    carry(loop, static_episode["reset_carry"])
    moved = run_port(loop, static_episode)
    metrics_equal(loop.metrics(), static_episode["metrics"], moved)
    assert moved <= 1


def test_loaded_episode_runs_free_on_the_references_decisions(jx, loaded_episode):
    """The loaded loop run free (no carrying): see free_run. The knife edge
    shows on this episode: the port's iterations leave the reference's."""
    loop = port_loop(LOADED)
    loop.reset(0, draws=loaded_episode["reset_draws"])
    strict, knife, differ = free_run(jx, LOADED, loop, loaded_episode)
    assert strict >= 3 and knife <= 1 and differ >= 1


# -- the port's own draws and budget -------------------------------------------------------
def test_own_draws_are_counter_based():
    loop = port_loop(CHAOS)
    loop.reset(5)
    a, b, c = loop.epoch_draws(3), loop.epoch_draws(3), loop.epoch_draws(4)

    def leaves(d):
        if isinstance(d, dict):
            return [x for k in sorted(d) for x in leaves(d[k])]
        if isinstance(d, tuple):
            return [x for v in d for x in leaves(v)]
        return [d]
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(c)))
    # epoch t's draws depend on (seed, t) alone: a second loop, stepped past
    # epoch 3, draws the same epoch 3
    other = port_loop(CHAOS)
    other.reset(5)
    for _ in range(4):
        other.step_epoch()
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(other.epoch_draws(3))))
    other.reset(6)
    assert not all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(other.epoch_draws(3))))
    # and a whole episode replays from its seed
    m1 = port_loop(CHAOS).run(11, 8, record=True)
    m2 = port_loop(CHAOS).run(11, 8, record=True)
    assert m1 == m2


class _ReadCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts reads of tensor values on the host (item / int / bool / float
    all dispatch to _local_scalar_dense) and data-dependent shapes, outside
    F.one_hot: on the CPU one_hot reads its input's min and max for a bounds
    check, which it leaves to the kernel on the card."""

    READS = ("aten._local_scalar_dense.default", "aten.nonzero.default", "aten.equal.default")

    def __init__(self):
        super().__init__()
        self.reads = 0
        self.in_one_hot = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.reads += str(func) in self.READS and not self.in_one_hot
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("hardened", [False, True])
def test_host_reads_per_epoch_are_the_budget(hardened, monkeypatch):
    """record=False: each epoch reads the trigger, the health word (hardened
    loop) and, on a replan, the server's plan word; the solver's stop flags
    are counted by li_gd. Nothing else reads the host."""
    rc = _ReadCounter()
    one_hot = torch.nn.functional.one_hot

    def counted_one_hot(*args, **kwargs):
        rc.in_one_hot += 1
        try:
            return one_hot(*args, **kwargs)
        finally:
            rc.in_one_hot -= 1
    monkeypatch.setattr(torch.nn.functional, "one_hot", counted_one_hot)
    cfg = dict(CHAOS, degrade={} if hardened else None)
    loop = port_loop(cfg)
    loop.reset(3)
    replans = 0
    for _ in range(7):
        counts = [dict(c) for c in (looplib.COUNTS, serve.COUNTS, li_gd.COUNTS)]
        rc.reads = 0
        with rc:
            loop.step_epoch()
        loop_reads = looplib.COUNTS["host_reads"] - counts[0]["host_reads"]
        plan_reads = serve.COUNTS["host_reads"] - counts[1]["host_reads"]
        gd_reads = li_gd.COUNTS["host_reads"] - counts[2]["host_reads"]
        assert loop_reads == 1 + hardened
        assert plan_reads == int(loop.server.last_replanned)
        assert rc.reads == loop_reads + plan_reads + gd_reads
        replans += loop.server.last_replanned
    assert 0 < replans < 7


def test_zero_fault_hardened_matches_plain():
    """With a zero fault config and admission shedding off, the hardened
    loop's traffic outcomes equal the plain loop's: injection is an exact
    identity and the ladder never engages (tests/test_faults.py)."""
    plain = port_loop(dict(CHAOS, faults=None, degrade=None))
    hard = port_loop(dict(CHAOS, faults={}, degrade=dict(shed_service_factor=0.0)))
    m_p = plain.run(3, 14, record=True)
    m_h = hard.run(3, 14, record=True)
    assert (m_p["completed"], m_p["offered"]) == (m_h["completed"], m_h["offered"])
    assert m_h["bad_plans"] == 0 and m_h["quarantines"] == 0
    assert m_p["history"]["s"] == m_h["history"]["s"]
    assert m_p["history"]["p95"] == m_h["history"]["p95"]


def test_loop_conserves_requests_and_guards_devices():
    loop = port_loop(LOADED)
    m = loop.run(2, 20)
    in_flight, queued = int(loop._bt.active.sum()), int(loop._bt.q_size)
    assert m["offered"] == m["completed"] + m["dropped"] + in_flight + queued
    assert m["served"] == m["completed"] and m["epochs"] == 20
    assert m["replans"] >= 20 // LOADED["service"]["replan_every"]
    with pytest.raises(ValueError, match="one device"):
        OnlineLoop(Scenario(ScenarioConfig(**LOADED["scen"]), device="cpu"),
                   PlannerEngine(profiles.nin(), device="meta"),
                   StreamConfig(**LOADED["stream"]))
    with pytest.raises(RuntimeError, match="before reset"):
        port_loop(LOADED).step_epoch()
