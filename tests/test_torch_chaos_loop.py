"""The port's hardened and unguarded OnlineLoop under chaos against the JAX
package's, on the CPU, and a reference episode carried across mid-way.

Configuration: tests/test_faults.py's (U=6, N=2, M=3, NiN, Adam
max_iters=40, the "full" fault mix at a 20 % link-outage rate: deep fades,
AP blackouts, telemetry drops and spikes, service spikes). The episodes run
on the reference's draws, on both SINR backends, in lock-step, and are
held after every epoch as test_torch_online_loop.py holds the loaded loop
(check_epoch: discrete outputs, ladder state, server counters and per-split
iterations exactly; the loop's floats within 1e-5; the served plan at the
engine's parity bound), with a fault-rate swap at epoch 12; the hardened
episode also runs free (free_run).

The carry-across stops the reference's hardened episode after 10 epochs,
turns its whole state into the port's with repro_torch.convert (scenario,
stream, batch, QoS, telemetry and fault states, the served plan, the
server's PlanState and counters, the ladder) and goes on in the port on
the reference's draws, held as above to the reference's own epochs 10-23.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_online_loop import (  # noqa: E402
    CHAOS,
    _record,
    carry,
    check_epoch,
    free_run,
    metrics_equal,
    port_loop,
    ref_episode,
    run_port,
)

from repro_torch import convert  # noqa: E402
from repro_torch.core import channel  # noqa: E402
from repro_torch.faults import FaultConfig  # noqa: E402

N_EPOCHS = 24
# The unguarded arm's NaN plans run every split to max_iters: fewer epochs.
N_UNGUARDED = 16
SWAP = (12, dict(link_outage_rate=0.5, telemetry_drop_rate=0.3))
SNAPSHOT_AT = 10
SEED = 7


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


def _snapshot(loop) -> dict:
    """The reference loop's whole episode state as numpy / host values."""
    sc, ps = loop._sc, loop.server.state
    return {
        "sc": dict(pos=np.asarray(sc.mob.pos), waypoint=np.asarray(sc.mob.waypoint),
                   ap_pos=np.asarray(sc.ap_pos), h_up=np.asarray(sc.h_up),
                   h_dn=np.asarray(sc.h_dn), epoch=np.asarray(sc.epoch)),
        "st": {k: np.asarray(v) for k, v in loop._st._asdict().items()},
        **{name: {k: np.asarray(v) for k, v in getattr(loop, "_" + name)._asdict().items()}
           for name in ("bt", "qs", "tel", "fs")},
        "carry": {"state": None if ps is None else {
            "plan": {f.name: np.asarray(getattr(ps.plan, f.name))
                     for f in dataclasses.fields(ps.plan)},
            "norms": {k: np.asarray(v) for k, v in ps.norms.items()},
            "moms": tuple({k: np.asarray(v) for k, v in m.items()} for m in ps.moms),
            "opt_steps": np.asarray(ps.opt_steps), "gains": np.asarray(ps.gains),
            "total_iters": np.asarray(ps.total_iters),
            "warm_rho": None if ps.warm_rho is None else np.asarray(ps.warm_rho)},
            "plan": {f.name: np.asarray(getattr(loop._plan, f.name))
                     for f in dataclasses.fields(loop._plan)}},
        "server": loop.server.export_host(), "iters_acc": np.asarray(loop.server._iters_acc),
        "ladder": loop.ladder.export_state(),
    }


@pytest.fixture(scope="module")
def hardened_episode(jx):
    return ref_episode(jx, CHAOS, N_EPOCHS, seed=SEED, swap=SWAP, snapshot_at=SNAPSHOT_AT,
                       snapshot=_snapshot)


@pytest.fixture(scope="module")
def unguarded_episode(jx):
    return ref_episode(jx, dict(CHAOS, degrade=None), N_UNGUARDED, seed=SEED, swap=SWAP)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("arm", ["hardened", "unguarded"])
def test_chaos_episode_matches_reference(request, arm, backend):
    """24 epochs of the chaos mix in lock-step with the ladder on
    (hardened), 16 with it off (unguarded, which serves the NaN plans a
    dropped telemetry sample breeds), the rates swapped at epoch 12."""
    ep = request.getfixturevalue(f"{arm}_episode")
    prev = channel.set_sinr_backend(backend)
    try:
        loop = port_loop(dict(CHAOS, degrade={} if arm == "hardened" else None), backend)
        loop.reset(SEED, draws=ep["reset_draws"])
        check_epoch(_record(loop), ep["reset"], "reset")
        carry(loop, ep["reset_carry"])
        moved = run_port(loop, ep, swap=SWAP)
        metrics_equal(loop.metrics(), ep["metrics"], moved)
        assert moved <= 1
    finally:
        channel.set_sinr_backend(prev)
    faulted = sum(int(e["faulted"]) for e in ep["epochs"])
    health = [int(e["health"]) for e in ep["epochs"]]
    assert faulted > 0 and any(health)            # the faults fired
    if arm == "hardened":
        assert all(e["plan_finite"] for e in ep["epochs"])
        assert ep["metrics"]["quarantines"] >= 1
    else:
        assert not all(e["plan_finite"] for e in ep["epochs"])


def test_hardened_episode_runs_free_on_the_references_decisions(jx, hardened_episode):
    """The hardened chaos episode run free (no carrying; see free_run)."""
    loop = port_loop(CHAOS)
    loop.reset(SEED, draws=hardened_episode["reset_draws"])
    strict, knife, _ = free_run(jx, CHAOS, loop, hardened_episode, swap=SWAP)
    assert strict >= 4 and knife <= 1


def test_reference_episode_carried_across_goes_on_identically(hardened_episode):
    """The reference's hardened episode stopped after 10 epochs, carried into
    the port with convert, and run on: every later epoch (in lock-step) and
    the final metrics equal the reference's own."""
    snap = hardened_episode["snapshot"]
    loop = port_loop(CHAOS)
    loop.reset(0)           # builds the loop's state; all of it is replaced
    loop._sc = convert.scenario_state_from_numpy(**snap["sc"], device="cpu")
    loop._st = convert.stream_state_from_numpy(**snap["st"], device="cpu")
    loop._bt = convert.batch_state_from_numpy(device="cpu", **snap["bt"])
    loop._qs = convert.qos_state_from_numpy(device="cpu", **snap["qs"])
    loop._tel = convert.telemetry_state_from_numpy(device="cpu", **snap["tel"])
    loop._fs = convert.fault_state_from_numpy(**snap["fs"], device="cpu")
    carry(loop, snap["carry"])
    loop.server.import_host(snap["server"], convert.tensor(snap["iters_acc"], "cpu"))
    loop.ladder.import_state(snap["ladder"])
    loop.set_fault_rates(FaultConfig(**CHAOS["faults"]))
    assert loop._st.epoch == SNAPSHOT_AT
    moved = run_port(loop, hardened_episode, epochs=hardened_episode["epochs"][SNAPSHOT_AT:],
                     swap=SWAP, start=SNAPSHOT_AT)
    metrics_equal(loop.metrics(), hardened_episode["metrics"], moved)


def test_hardened_loop_conserves_requests_including_shed():
    """tests/test_faults.py TestHardenedLoop on the port's own draws."""
    loop = port_loop(CHAOS)
    m = loop.run(2, 30, record=True)
    in_flight, queued = int(loop._bt.active.sum()), int(loop._bt.q_size)
    assert m["offered"] == m["completed"] + m["dropped"] + m["shed"] + in_flight + queued
    assert m["goodput"] <= m["completed"]
    assert all(m["history"]["plan_finite"])
    loop.set_fault_rates(FaultConfig(link_outage_rate=0.5, telemetry_drop_rate=0.3))
    for _ in range(4):
        loop.step_epoch()
    assert loop.metrics()["epochs"] == 34
