"""The port's durable serving (repro_torch.state) on the CPU.

Configuration: tests/test_state.py's (U=6, N=2, M=3, NiN, Adam max_iters=30,
the "full" fault mix at a 20 % link-outage rate, the ladder with an
8-epoch quarantine), 18 epochs, a snapshot every 6, a crash before epoch
14, seed 3.

Port only, bit-exact (every leaf ``torch.equal`` with equal dtypes, Python
scalars equal, host dicts equal): the snapshot round trip, resume from a
snapshot and crash + supervised resume equal to the uninterrupted run, the
ladder's counters across a restore, refusal by fingerprint and of a leaf
of the wrong dtype or shape before anything is loaded, the store's cadence
and listing, recovery accounting, the history rewound, the escalation
(corrupt newest -> previous -> cold start), replay of the journal, tamper
and torn-tail detection, rate swaps rewound by a restore, the plan word,
the recorder's counted reads, and the DecodeBatcher cache round trip on
the reduced models.

Against the JAX package, fed the reference's draws in lock-step (the
helpers of test_torch_online_loop.py: the reference's PlanState and served
plan carried in after each replan), with a fault-rate swap at epoch 9:
the port's serving_state() at epoch 12 equals the reference's (ints and
bools exact, floats within 1e-5 of each leaf's largest magnitude, the host
dicts equal); the two journals agree record for record; each package's
read_journal reads the other's file; the reference's snapshot at epoch 12
(written by repro.state.save_snapshot, unflattened with the reference's
treedef, converted by convert.serving_state_from_numpy) goes on in the port
to the reference's epochs 12-17. The engine's PlanState template equals
the states plan() and replan() return.
"""
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_online_loop import (  # noqa: E402
    CHAOS_FAULTS,
    _record,
    carry,
    check_epoch,
    port_loop,
    ref_episode,
    run_port,
)

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import GdConfig, profiles  # noqa: E402
from repro_torch.core.channel import make_env  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402
from repro_torch.faults import FaultConfig  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.online import DecodeBatcher, StreamConfig  # noqa: E402
from repro_torch.online import loop as looplib  # noqa: E402
from repro_torch.planning import PlannerEngine, plan_state_template  # noqa: E402
from repro_torch.state import (  # noqa: E402
    CrashSupervisor,
    FlightRecorder,
    SimulatedCrash,
    SnapshotConfig,
    SnapshotIntegrityError,
    SnapshotStore,
    effective_trajectory,
    list_snapshots,
    load_snapshot,
    pack_word,
    read_journal,
    replay,
    save_snapshot,
    unpack_word,
)
from repro_torch.state import snapshot as snaplib  # noqa: E402

# tests/test_state.py's configuration
STATE = dict(scen=dict(n_users=6, n_aps=2, n_sub=3, fading_rho=0.95),
             stream=dict(arrival_rate_hz=20.0, epoch_dt_s=0.02, deadline_s=0.2),
             service=dict(edge_capacity=4, queue_depth=8, load_gain=4.0, replan_every=3,
                          max_work_epochs=200),
             gd=dict(step_size=3e-2, eps=1e-4, max_iters=30, optimizer="adam"),
             faults=CHAOS_FAULTS, degrade=dict(quarantine_epochs=8, baseline_after=2),
             feedback=True)
T, CADENCE, CRASH_AT = 18, 6, 14
SEED = 3
RTOL = 1e-5
SWAP = (9, dict(link_outage_rate=0.5, telemetry_drop_rate=0.3))


def make_loop():
    return port_loop(STATE)


def leaves(tree) -> list:
    """Host copies of a tree's leaves (tensors cloned: later epochs build new
    tensors, but a copy makes the comparison independent of that)."""
    flat, td = tree_flatten(tree)
    return [str(td)] + [x.clone() if isinstance(x, torch.Tensor) else x for x in flat]


def same_leaves(a: list, b: list) -> list:
    """Indices of the leaves that differ (the structure string is leaf 0):
    tensors must have equal dtypes and be torch.equal, scalars equal and of
    one type."""
    bad = []
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor):
            ok = isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
        else:
            ok = type(x) is type(y) and x == y
        if not ok:
            bad.append(i)
    return bad if len(a) == len(b) else bad + ["length"]


def state_of(loop) -> dict:
    dev, host = loop.serving_state()
    return {"dev": leaves(dev), "host": json.loads(json.dumps(host))}


def assert_same_state(got: dict, want: dict) -> None:
    assert same_leaves(got["dev"], want["dev"]) == []
    assert got["host"] == want["host"]


def _crash_once(at: int):
    armed = [True]

    def chaos(next_epoch: int) -> None:
        if next_epoch == at and armed[0]:
            armed[0] = False
            raise SimulatedCrash(f"injected kill before epoch {at}")
    return chaos


def _crash_and_rot(at: int, dst: str, epochs: tuple):
    """Chaos hook: right before the kill, bit-rot the snapshots at
    ``epochs`` (corruption between the save and the crash)."""
    armed = [True]

    def chaos(next_epoch: int) -> None:
        if next_epoch == at and armed[0]:
            armed[0] = False
            for e in epochs:
                with open(os.path.join(dst, f"snap_{e:08d}", "leaves.npz"), "wb") as f:
                    f.write(b"not a zip archive")
            raise SimulatedCrash(f"injected kill before epoch {at}")
    return chaos


# -- the port alone, bit-exact -----------------------------------------------------------
@pytest.fixture(scope="module")
def uninterrupted():
    loop = make_loop()
    loop.reset(SEED)
    for _ in range(T):
        loop.step_epoch()
    return state_of(loop)


@pytest.fixture(scope="module")
def snapped(tmp_path_factory):
    """A loop stepped to 2*CADENCE with a sync SnapshotStore on cadence."""
    td = str(tmp_path_factory.mktemp("snapped"))
    store = SnapshotStore(td, SnapshotConfig(every=CADENCE, keep_n=3, asynchronous=False))
    loop = make_loop()
    loop.reset(SEED)
    saved = []
    for _ in range(2 * CADENCE):
        loop.step_epoch()
        if store.maybe_save(loop) is not None:
            saved.append(loop.host_epoch)
    assert saved == [CADENCE, 2 * CADENCE]
    return {"store": td, "saves": store.saves, "ladder_at_cut": loop.ladder.export_state(),
            "at_cut": state_of(loop)}


@pytest.fixture(scope="module")
def resumed(snapped):
    """The 2*CADENCE snapshot restored into a fresh loop, run to T."""
    fresh = make_loop()
    fresh.reset(SEED)
    load_snapshot(snapped["store"], fresh, 2 * CADENCE)
    at_restore = state_of(fresh)
    ladder_at_restore = fresh.ladder.export_state()
    for _ in range(T - 2 * CADENCE):
        fresh.step_epoch()
    return {"final": state_of(fresh), "at_restore": at_restore,
            "ladder_at_restore": ladder_at_restore}


def test_snapshot_round_trip(snapped, resumed):
    """Restored leaf for leaf: the state right after load_snapshot is the
    state that was saved."""
    assert_same_state(resumed["at_restore"], snapped["at_cut"])


def test_resume_is_bit_exact(resumed, uninterrupted):
    assert_same_state(resumed["final"], uninterrupted)


def test_ladder_counters_survive_restore(resumed, snapped, uninterrupted):
    assert resumed["ladder_at_restore"] == snapped["ladder_at_cut"]
    assert resumed["ladder_at_restore"]["epoch"] == 2 * CADENCE
    assert resumed["final"]["host"]["ladder"] == uninterrupted["host"]["ladder"]


def test_fingerprint_mismatch_refuses_restore(snapped):
    other = port_loop(dict(STATE, stream=dict(STATE["stream"], arrival_rate_hz=25.0)))
    other.reset(SEED)
    before = state_of(other)
    assert other.config_fingerprint() != make_loop().config_fingerprint()
    assert make_loop().config_fingerprint() == make_loop().config_fingerprint()
    with pytest.raises(SnapshotIntegrityError, match="fingerprint"):
        load_snapshot(snapped["store"], other, 2 * CADENCE)
    assert_same_state(state_of(other), before)


@pytest.mark.parametrize("what", ["dtype", "shape"])
def test_wrong_leaf_refused_before_anything_loads(snapped, tmp_path, what):
    """A stored leaf of the wrong dtype or shape fails against the live
    template before leaves.npz is opened (its bytes are garbage here), and
    the loop is left as it was."""
    dst = str(tmp_path / "snaps")
    shutil.copytree(snapped["store"], dst)
    path = os.path.join(dst, f"snap_{2 * CADENCE:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    i = meta["dtypes"].index("complex64")          # the scenario's h_up
    if what == "dtype":
        meta["dtypes"][i] = "complex128"
    else:
        meta["shapes"][i] = meta["shapes"][i][:-1] + [meta["shapes"][i][-1] + 1]
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(path, "leaves.npz"), "wb") as f:
        f.write(b"never read")
    loop = make_loop()
    loop.reset(SEED)
    before = state_of(loop)
    with pytest.raises(SnapshotIntegrityError, match=f"leaf {i} is .*live loop expects"):
        load_snapshot(dst, loop, 2 * CADENCE)
    assert_same_state(state_of(loop), before)


def test_store_cadence_and_listing(snapped):
    assert list_snapshots(snapped["store"]) == [CADENCE, 2 * CADENCE]
    assert snapped["saves"] == 2


def test_rejected_first_plan_snapshots_a_zero_cold_state(tmp_path):
    """A server with no state (its first plan rejected) snapshots a
    zero-filled cold-shaped PlanState as kind "none" and restores to no
    state."""
    loop = make_loop()
    loop.reset(SEED)
    loop.server.state = None
    dev, host = loop.serving_state()
    assert host["plan_state_kind"] == "none"
    flat, _ = tree_flatten(dev["server_state"])
    assert dev["server_state"].warm_rho is None and all(not x.any() for x in flat)
    save_snapshot(str(tmp_path), loop)
    fresh = make_loop()
    fresh.reset(SEED)
    load_snapshot(str(tmp_path), fresh, 0)
    assert fresh.server.state is None
    assert_same_state(state_of(fresh), state_of(loop))


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    """A supervised, journaled run (asynchronous snapshots) killed before
    epoch CRASH_AT and resumed from the newest snapshot."""
    td = str(tmp_path_factory.mktemp("crashed"))
    journal = os.path.join(td, "flight.jsonl")
    rec = FlightRecorder(journal)
    store = SnapshotStore(os.path.join(td, "snaps"),
                          SnapshotConfig(every=CADENCE, keep_n=3, asynchronous=True))
    sup = CrashSupervisor(make_loop, store=store, recorder=rec)
    m = sup.run(SEED, T, record=True, chaos=_crash_once(CRASH_AT))
    rec.close()
    return {"sup": sup, "metrics": m, "final": state_of(sup.loop), "journal": journal}


def test_crash_resume_matches_uninterrupted(crashed, uninterrupted):
    assert_same_state(crashed["final"], uninterrupted)


def test_recovery_accounting(crashed):
    sup = crashed["sup"]
    # killed before epoch 14 (12 + 13 done), resumed from the snapshot at
    # 12: exactly one re-executed epoch
    assert sup.restarts == 1 and sup.cold_restarts == 0
    assert sup.restored_from == [2 * CADENCE]
    assert sup.recovery_epochs == (CRASH_AT - 1) - 2 * CADENCE
    m = crashed["metrics"]
    assert m["snapshots_saved"] == 3 and m["supervisor_recovery_epochs"] == 1


def test_history_rewound_not_duplicated(crashed, uninterrupted):
    hist = crashed["metrics"]["history"]
    assert all(len(col) == T for col in hist.values())
    loop = make_loop()
    assert hist == loop.run(SEED, T, record=True)["history"]


def test_corrupt_newest_escalates_to_previous(uninterrupted, tmp_path):
    dst = str(tmp_path / "snaps")
    store = SnapshotStore(dst, SnapshotConfig(every=CADENCE, keep_n=3, asynchronous=False))
    sup = CrashSupervisor(make_loop, store=store)
    sup.run(SEED, T, chaos=_crash_and_rot(CRASH_AT, dst, (2 * CADENCE,)))
    assert sup.restored_from == [CADENCE]
    assert sup.corrupt_snapshots == 1
    assert sup.recovery_epochs == (CRASH_AT - 1) - CADENCE
    assert_same_state(state_of(sup.loop), uninterrupted)


def test_all_corrupt_falls_to_cold_start(uninterrupted, tmp_path):
    dst = str(tmp_path / "snaps")
    store = SnapshotStore(dst, SnapshotConfig(every=CADENCE, keep_n=3, asynchronous=False))
    sup = CrashSupervisor(make_loop, store=store)
    sup.run(SEED, T, chaos=_crash_and_rot(CRASH_AT, dst, (CADENCE, 2 * CADENCE)))
    assert sup.cold_restarts == 1 and sup.corrupt_snapshots == 2
    assert sup.restored_from == [0]
    assert sup.recovery_epochs == CRASH_AT - 1
    # a cold restart replays deterministically from epoch 0
    assert_same_state(state_of(sup.loop), uninterrupted)


def test_replay_reproduces_trajectory(crashed):
    records, clean = read_journal(crashed["journal"])
    assert clean and records
    traj = effective_trajectory(records)
    assert traj["seed"] == SEED
    assert sorted(traj["epochs"]) == list(range(1, T + 1))
    assert [r["kind"] for r in records].count("restore") == 1
    assert [r["kind"] for r in records].count("snapshot") == 3
    res = replay(records, make_loop)
    assert res == {"epochs": T, "divergence": None}


def test_tampered_word_detected_by_replay(crashed):
    records, _ = read_journal(crashed["journal"])
    tampered = [dict(r) for r in records]
    victim = next(r for r in tampered if r["kind"] == "epoch" and r["t"] == 5)
    victim["word"] ^= 1              # flip the served s* by one
    res = replay(tampered, make_loop)
    assert res["divergence"] is not None and res["divergence"]["t"] == 5


def test_crc_tamper_truncates_read(crashed, tmp_path):
    path = str(tmp_path / "flight.jsonl")
    shutil.copy(crashed["journal"], path)
    with open(path) as f:
        lines = f.readlines()
    rec = json.loads(lines[4])
    rec["word"] = rec.get("word", 0) ^ 1   # crc left stale
    lines[4] = json.dumps(rec, sort_keys=True) + "\n"
    with open(path, "w") as f:
        f.writelines(lines)
    records, clean = read_journal(path)
    assert not clean and len(records) == 4


def test_torn_tail_tolerated(tmp_path):
    path = str(tmp_path / "flight.jsonl")
    rec = FlightRecorder(path)
    rec.record_start(0, "fp")
    rec.record_epoch(1, s=4, health=3, trigger=False, stage="normal")
    rec.close()
    with open(path, "a") as f:
        f.write('{"kind": "epoch", "t": 2, ')   # crash mid-write
    records, clean = read_journal(path)
    assert not clean
    assert [r["kind"] for r in records] == ["start", "epoch"]


def test_restore_rewinds_rate_swaps():
    records = [
        {"kind": "start", "seed": 0, "fingerprint": "fp"},
        {"kind": "rates", "t": 3, "rates": {"link_outage_rate": 0.5}},
        {"kind": "rates", "t": 9, "rates": {"link_outage_rate": 0.9}},
        {"kind": "restore", "t": 10, "from": 6},
    ]
    assert effective_trajectory(records)["rates"] == [(3, {"link_outage_rate": 0.5})]


def test_pack_word_roundtrip():
    for health, s in ((0, 0), (3, 41), (7, 65535), (255, 9)):
        assert unpack_word(pack_word(health, s)) == (health, s)


def test_recorder_and_capture_reads_are_counted(tmp_path):
    """An attached recorder reads one word an epoch, counted apart from the
    loop's own reads (which stay at the trigger and the health word); a
    snapshot is one capture."""
    loop = make_loop()
    loop.attach_recorder(FlightRecorder(str(tmp_path / "j.jsonl")))
    loop.reset(SEED)
    looplib.reset_counts()
    snaplib.reset_counts()
    for _ in range(4):
        out, _ = loop.step_epoch()
        health, s = unpack_word(int(loop.served_word(out)))
        assert (health, s) == (int(out.health), int(loop._plan.s))
    assert looplib.COUNTS["recorder_reads"] == 4 and looplib.COUNTS["host_reads"] == 8
    save_snapshot(str(tmp_path / "snaps"), loop)
    assert snaplib.COUNTS["captures"] == 1 and snaplib.COUNTS["bytes"] > 0
    loop._recorder.close()


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "qwen1.5-0.5b"])
def test_decode_batcher_cache_export_import_roundtrip(name):
    """Slot caches export as host copies and import back bit-exactly: the
    same two decode steps after an import give the same logits and caches;
    a cache of another shape is refused, naming the leaf."""
    cfg = configs.get(name).reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    b, s_len = 2, 6
    toks = torch.randint(0, cfg.vocab_size, (b, s_len),
                         generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    db = DecodeBatcher(model, None, capacity=b, max_len=s_len + 4)
    for i in range(b):
        db.admit(i, toks[i:i + 1])
    snap = db.export_caches()
    live0 = leaves(db.caches)
    tok = torch.zeros((b, 1), dtype=torch.int32)
    active = torch.tensor([True, True])
    first = [db.step(tok, active) for _ in range(2)]
    after = leaves(db.caches)
    assert same_leaves(leaves(snap), live0) == []      # the export is a copy
    db.import_caches(snap)
    assert same_leaves(leaves(db.caches), live0) == []
    again = [db.step(tok, active) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert same_leaves(leaves(db.caches), after) == []
    bad = dict(snap, pos=snap["pos"][:1])
    with pytest.raises(ValueError, match="leaf"):
        db.import_caches(bad)


@pytest.mark.parametrize("backend", ["einsum", "kernel"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_plan_state_template_matches_real_states(optimizer, backend):
    """The engine's PlanState template has the fields, None fields, shapes
    and dtypes of the states plan() and replan() return."""
    env0 = make_env(7, 2, 3, seed=0, device="cpu")
    env1 = make_env(7, 2, 3, seed=1, device="cpu")
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(step_size=3e-2, eps=1e-4, max_iters=8,
                                                     optimizer=optimizer),
                        sinr_backend=backend, device="cpu")
    cold = eng.plan(env0)
    warm = eng.replan(cold, env1)
    f1 = profiles.nin().n_layers + 1
    for state, is_warm in ((cold, False), (warm, True)):
        real, td = tree_flatten(state)
        tmpl, td_t = tree_flatten(plan_state_template(7, 2, 3, f1, warm=is_warm,
                                                      device="meta"))
        assert td_t == td, (str(td_t), str(td))
        assert [(x.dtype, x.shape) for x in tmpl] == [(x.dtype, x.shape) for x in real]


def test_fleet_plan_state_template_matches_plan_many():
    envs = [make_env(5, 2, 3, seed=s, device="cpu") for s in (0, 1)]
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(max_iters=4, optimizer="adam"),
                        device="cpu")
    cold = eng.plan_many(envs)
    warm = eng.replan_many(cold, envs)
    for state, is_warm in ((cold, False), (warm, True)):
        real, td = tree_flatten(state)
        tmpl, td_t = tree_flatten(plan_state_template(5, 2, 3, 10, warm=is_warm, fleet=2,
                                                      device="meta"))
        assert td_t == td
        assert [(x.dtype, x.shape) for x in tmpl] == [(x.dtype, x.shape) for x in real]


# -- against the JAX package, in lock-step -------------------------------------------------
CUT = 12


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
def ref_run(jx, tmp_path_factory):
    """The reference's episode with its own flight recorder attached, a rate
    swap at epoch 9, and its snapshot at epoch CUT written by
    repro.state.save_snapshot (with its treedef and device state)."""
    import repro.state as jstate
    jax = jx["jax"]
    td = str(tmp_path_factory.mktemp("ref"))
    journal = os.path.join(td, "ref.jsonl")
    rec = jstate.FlightRecorder(journal)
    JLoop = jx["mods"]["OnlineLoop"]

    def recorded_loop(*args, **kwargs):
        loop = JLoop(*args, **kwargs)
        loop.attach_recorder(rec)
        return loop

    def snapshot(loop):
        path = jstate.save_snapshot(os.path.join(td, "snaps"), loop)
        dev, host = loop.serving_state()
        return {"path": path, "treedef": jax.tree_util.tree_flatten(dev)[1],
                "dev": jax.device_get(dev), "host": host}

    ep = ref_episode(dict(jx, mods=dict(jx["mods"], OnlineLoop=recorded_loop)), STATE, T,
                     seed=SEED, swap=SWAP, snapshot_at=CUT, snapshot=snapshot)
    rec.close()
    return {"ep": ep, "journal": journal}


@pytest.fixture(scope="module")
def port_run(ref_run, tmp_path_factory):
    """The port's loop on the reference's draws in lock-step, journaled, its
    serving_state() taken at CUT."""
    ep = ref_run["ep"]
    journal = os.path.join(str(tmp_path_factory.mktemp("port")), "port.jsonl")
    rec = FlightRecorder(journal)
    loop = make_loop()
    loop.attach_recorder(rec)
    loop.reset(SEED, draws=ep["reset_draws"])
    check_epoch(_record(loop), ep["reset"], "reset")
    carry(loop, ep["reset_carry"])
    moved = run_port(loop, ep, epochs=ep["epochs"][:CUT], swap=SWAP)
    at_cut = loop.serving_state()
    moved += run_port(loop, ep, epochs=ep["epochs"][CUT:], swap=SWAP, start=CUT)
    rec.close()
    return {"at_cut": at_cut, "journal": journal, "moved": moved}


def _leaf_close(got, want, what: str) -> None:
    """Ints and bools exact, floats (complex by parts) within RTOL of the
    leaf's largest magnitude."""
    if not isinstance(got, torch.Tensor):
        assert type(got) is type(want) and got == want, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if not (got.is_floating_point() or got.is_complex()):
        assert torch.equal(got, want), what
        return
    g, w = (torch.view_as_real(x) if x.is_complex() else x for x in (got, want))
    g, w = g.double(), w.double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    scale = float(w[torch.isfinite(w)].abs().max()) if torch.isfinite(w).any() else 0.0
    err = torch.where(same, torch.zeros_like(g), (g - w).abs())
    assert bool(torch.all(same | (err <= RTOL * scale))), (what, got, want)


def test_serving_state_matches_reference_at_the_cut(ref_run, port_run):
    snap = ref_run["ep"]["snapshot"]
    want_dev, want_host = convert.serving_state_from_numpy(snap["dev"], snap["host"], SEED,
                                                           device="cpu")
    got_dev, got_host = port_run["at_cut"]
    assert got_host.pop("base") == make_loop().seeds(SEED)["base"]
    want_host.pop("base")
    assert json.loads(json.dumps(got_host)) == json.loads(json.dumps(want_host))
    got, td = tree_flatten(got_dev)
    want, td_w = tree_flatten(want_dev)
    assert td == td_w
    for i, (g, w) in enumerate(zip(got, want)):
        _leaf_close(g, w, f"leaf {i} of {td}")


def test_journals_agree_record_for_record(ref_run, port_run):
    theirs, clean_t = read_journal(ref_run["journal"])
    ours, clean_o = read_journal(port_run["journal"])
    assert clean_t and clean_o
    assert [r["kind"] for r in ours] == [r["kind"] for r in theirs]
    assert [r["kind"] for r in ours].count("epoch") == T
    for a, b in zip(ours, theirs):
        keys = ("t", "word", "trigger", "stage") if a["kind"] == "epoch" else ("t", "rates")
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}, (a, b)
    assert port_run["moved"] <= 1


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_read_journal_reads_the_other_packages_file(ref_run, port_run, tmp_path, writer,
                                                    torn):
    import repro.state as jstate
    path = str(tmp_path / "j.jsonl")
    shutil.copy(ref_run["journal"] if writer == "ref" else port_run["journal"], path)
    if torn:
        with open(path, "a") as f:
            f.write('{"kind": "epoch", "t": 19, "wo')
    got = read_journal(path)
    want = jstate.read_journal(path)
    assert got == want
    assert got[1] is (not torn) and len(got[0]) == T + 1


def test_reference_snapshot_carried_across_goes_on_identically(ref_run, tmp_path):
    """The reference's snapshot at epoch CUT, read from its leaves.npz with
    the reference's treedef and converted, restores into a port loop reset
    on the reference's draws; the port then gives the reference's epochs
    CUT..T-1 (s*, arrivals, completions, queues, triggers, server counters,
    ladder state and the loop's floats, check_epoch) in lock-step."""
    import jax
    ep, snap = ref_run["ep"], ref_run["ep"]["snapshot"]
    with open(os.path.join(snap["path"], "meta.json")) as f:
        meta = json.load(f)
    assert meta["treedef"] == str(snap["treedef"]) and meta["epoch"] == CUT
    with np.load(os.path.join(snap["path"], "leaves.npz")) as data:
        arrays = [data[f"a{i}"] for i in range(meta["n_leaves"])]
    dev_np = jax.tree_util.tree_unflatten(snap["treedef"], arrays)
    dev, host = convert.serving_state_from_numpy(dev_np, meta["host"], SEED, device="cpu")
    loop = make_loop()
    loop.reset(SEED, draws=ep["reset_draws"])
    loop.load_serving_state(dev, host)
    assert loop.host_epoch == CUT and loop._st.epoch == CUT and loop._sc.epoch == CUT
    swapped = FaultConfig(**SWAP[1]).rates("cpu")
    assert all(torch.equal(a, b) for a, b in zip(loop._rates, swapped))   # rates travel
    moved = run_port(loop, ep, epochs=ep["epochs"][CUT:], start=CUT)
    assert moved <= 1
    assert loop.host_epoch == T


def test_other_stream_config_has_other_fingerprint():
    a = make_loop()
    b = port_loop(dict(STATE, stream=dict(STATE["stream"], deadline_s=0.3)))
    assert a.config_fingerprint() != b.config_fingerprint()
    assert StreamConfig(**STATE["stream"]) == a.stream_cfg
