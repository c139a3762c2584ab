"""The port's online package (streams, batcher, telemetry, QoS) alone and
against the JAX package, on the CPU.

  * the JAX package's tests/test_online.py cases on the port;
  * the stream's deterministic core fed the reference's draws (its epoch
    key split in three: Poisson counts before the cap, the churn and the
    fresh-session uniforms, a Bernoulli(p) being uniform < p): the same
    counts and sessions, epoch after epoch (integers and booleans, so
    exact);
  * enqueue / admit / tick over random batches, each from the same state
    in both packages (the reference scans, the port takes prefix sums):
    integer state exactly, float state within 1e-6 (it is copied or
    subtracted once in float32, so in fact exactly); with a full ring,
    shed heads and more arrivals than the ring holds;
  * telemetry_update / measured_profile on the same observations: within
    1e-5 of each element's scale (float32 sums in another order, and XLA's
    pow against PyTorch's); the scale of a measured m_down entry includes
    its congestion term's (total FLOPs - prefix) * (kappa - 1) / speed *
    rate_dn at the total, since the difference cancels;
  * qos_update on the same completions, including NaN and inf latencies
    (guarded and not), more completions than the window, and a user
    completing in two slots of one epoch: integers exactly, floats within
    1e-6;
  * the service-time cast: ceil(service / dt) clipped to
    [1, max_work_epochs] on NaN, +-inf, 1e15, 3e9 * dt and 0.5 * dt, equal
    to the reference's saturating cast."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ComputeConstants, profiles  # noqa: E402
from repro_torch.core.types import ProfileShapeError, lam  # noqa: E402
from repro_torch.online import (  # noqa: E402
    ContinuousBatcher,
    Observation,
    QosConfig,
    QosMonitor,
    RequestStream,
    StreamConfig,
    Telemetry,
)
from repro_torch.online import batcher as batcherlib  # noqa: E402
from repro_torch.online import qos as qoslib  # noqa: E402
from repro_torch.online import streams as streamlib  # noqa: E402
from repro_torch.online import telemetry as tellib  # noqa: E402
from repro_torch.online.batcher import BatchState, Completions  # noqa: E402
from repro_torch.online.loop import work_epochs  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from repro.core import profiles as jprofiles
    from repro.core.types import ComputeConstants as JComp
    from repro.online import batcher as jbatcher
    from repro.online import qos as jqos
    from repro.online import streams as jstreams
    from repro.online import telemetry as jtelemetry
    return dict(jax=jax, jnp=jax.numpy, profiles=jprofiles, Comp=JComp, batcher=jbatcher,
                qos=jqos, streams=jstreams, telemetry=jtelemetry)


def _t(x):
    return torch.tensor(np.asarray(x))


def _assert_tuple(got, want, atol=1e-6):
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


# -- streams (tests/test_online.py) --------------------------------------------
def test_stream_deterministic_replay():
    cfg = StreamConfig(arrival_rate_hz=8.0, epoch_dt_s=0.1)
    st = RequestStream(cfg, 6, device="cpu")
    s1, s2 = st.init(0), st.init(0)
    ep1, ep2 = [], []
    for _ in range(5):
        s1, c1 = st.step(3, s1)
        s2, c2 = st.step(3, s2)
        ep1.append(c1.numpy())
        ep2.append(c2.numpy())
    np.testing.assert_array_equal(np.stack(ep1), np.stack(ep2))
    assert int(s1.offered) == int(np.sum(ep1)) and s1.epoch == 5
    # the draws' counter basis: (seed, t) alone decides epoch t
    a = streamlib.step_draws(cfg, 6, st.generator(3, 2))
    b = streamlib.step_draws(cfg, 6, st.generator(3, 2))
    c = streamlib.step_draws(cfg, 64, st.generator(3, 4))
    d = streamlib.step_draws(cfg, 64, st.generator(3, 5))
    assert torch.equal(a["counts"], b["counts"]) and not torch.equal(c["counts"], d["counts"])


def test_stream_poisson_rate_and_cap():
    cfg = StreamConfig(arrival_rate_hz=5.0, epoch_dt_s=0.2, max_per_user_epoch=3,
                       duty_cycle=1.0)
    st = RequestStream(cfg, 32, device="cpu")
    state = st.init(1)
    total, n = 0, 200
    for _ in range(n):
        state, counts = st.step(7, state)
        assert int(counts.max()) <= 3 and counts.dtype == torch.int32
        total += int(counts.sum())
    mean = total / (n * 32)
    assert 0.85 < mean < 1.1, mean       # E[min(Pois(1), 3)] ~ 0.97
    quiet = RequestStream(dataclasses.replace(cfg, duty_cycle=1e-9), 32, device="cpu")
    qs, counts = quiet.step(7, quiet.init(2))
    assert int(counts.sum()) == 0


def test_stream_session_churn_changes_population():
    cfg = StreamConfig(session_churn_hz=5.0, epoch_dt_s=0.5, duty_cycle=0.5)
    st = RequestStream(cfg, 64, device="cpu")
    state = st.init(0)
    before = state.session.clone()
    for _ in range(4):
        state, _ = st.step(9, state)
    assert not torch.equal(state.session, before)
    with pytest.raises(ValueError):
        RequestStream(StreamConfig(max_per_user_epoch=0), 4, device="cpu")
    with pytest.raises(ValueError):
        RequestStream(StreamConfig(duty_cycle=0.0), 4, device="cpu")


@pytest.mark.parametrize("churn", [0.0, 5.0])
def test_stream_core_on_reference_draws(jx, churn):
    jax = jx["jax"]
    cfg = StreamConfig(arrival_rate_hz=20.0, epoch_dt_s=0.1, session_churn_hz=churn,
                       duty_cycle=0.6, max_per_user_epoch=3)
    jcfg = jx["streams"].StreamConfig(**dataclasses.asdict(cfg))
    u = 50
    jst = jx["streams"].RequestStream(jcfg, u)
    k_init, base = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jstate = jst.init(k_init)
    state = RequestStream(cfg, u, device="cpu").init_from(_t(jax.random.uniform(k_init, (u,))))
    np.testing.assert_array_equal(state.session.numpy(), np.asarray(jstate.session))
    capped = 0
    for t in range(12):
        k_arr, k_churn, k_fresh = jax.random.split(jax.random.fold_in(base, t), 3)
        draws = {"counts": _t(jax.random.poisson(k_arr, 2.0, (u,), dtype=jax.numpy.int32))}
        if churn:
            draws["churn"] = _t(jax.random.uniform(k_churn, (u,)))
            draws["fresh"] = _t(jax.random.uniform(k_fresh, (u,)))
        capped += int((draws["counts"] > 3).sum())
        jstate, jcounts = jst.step(base, jstate)
        state, counts = streamlib.stream_step_from(cfg, u, draws, state)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(state.session.numpy(), np.asarray(jstate.session))
        assert (state.epoch, int(state.offered)) == (int(jstate.epoch), int(jstate.offered))
    assert capped > 0                      # the cap was exercised


# -- batcher (tests/test_online.py) -----------------------------------------------
def _step_batch(b, state, counts, now, service, work):
    u = len(counts)
    return b.step(state, torch.tensor(counts, dtype=torch.int32), torch.tensor(now),
                  torch.full((u,), service), torch.full((u,), work, dtype=torch.int32))


def test_batcher_fifo_admission_and_completion():
    b = ContinuousBatcher(capacity=2, queue_depth=8, max_per_user_epoch=4, device="cpu")
    state = b.init()
    state, comp = _step_batch(b, state, [4, 0], 0.0, 0.25, 2)
    assert int(batcherlib.occupancy(state)) == 2 and int(batcherlib.backlog(state)) == 2
    assert not bool(comp.valid.any())
    state, comp = _step_batch(b, state, [0, 0], 0.1, 0.25, 2)
    assert int(comp.valid.sum()) == 2
    np.testing.assert_allclose(comp.latency[comp.valid].numpy(), 0.25, atol=1e-6)
    assert int(batcherlib.occupancy(state)) == 0 and int(batcherlib.backlog(state)) == 2
    state, comp = _step_batch(b, state, [0, 0], 0.2, 0.25, 2)
    assert int(batcherlib.occupancy(state)) == 2 and int(batcherlib.backlog(state)) == 0
    state, comp = _step_batch(b, state, [0, 0], 0.3, 0.25, 2)
    np.testing.assert_allclose(comp.latency[comp.valid].numpy(), 0.2 + 0.25, atol=1e-5)
    assert int(state.completed) == 4


def test_batcher_drops_on_full_ring():
    b = ContinuousBatcher(capacity=1, queue_depth=2, max_per_user_epoch=4, device="cpu")
    state, _ = _step_batch(b, b.init(), [4], 0.0, 1.0, 100)
    assert int(state.dropped) == 2
    assert int(batcherlib.occupancy(state)) == 1 and int(batcherlib.backlog(state)) == 1
    with pytest.raises(ValueError):
        ContinuousBatcher(capacity=0, queue_depth=2, max_per_user_epoch=1, device="cpu")


def test_batcher_work_caps_slot_occupancy():
    b = ContinuousBatcher(capacity=1, queue_depth=4, max_per_user_epoch=1, device="cpu")
    state, comp = _step_batch(b, b.init(), [1], 0.0, 0.5, 3)
    for _ in range(2):
        assert int(batcherlib.occupancy(state)) == 1
        state, comp = _step_batch(b, state, [0], 0.0, 0.5, 3)
    assert bool(comp.valid.any()) and int(batcherlib.occupancy(state)) == 0


def _random_state(rng, b, q, u):
    """A consistent random BatchState: some slots busy, a ring of random
    size at a random head."""
    active = rng.random(b) < 0.5
    size = int(rng.integers(0, q + 1))
    head = int(rng.integers(0, q))
    q_user = np.full(q, -1, np.int32)
    q_t = np.zeros(q, np.float32)
    for r in range(size):
        q_user[(head + r) % q] = rng.integers(0, u)
        q_t[(head + r) % q] = np.float32(rng.uniform(0, 1))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(active=active, user=np.where(active, rng.integers(0, u, b), -1).astype(np.int32),
                t_arr=f32(rng.uniform(0, 1, b) * active), wait=f32(rng.uniform(0, 1, b) * active),
                serv=f32(rng.uniform(0, 1, b) * active),
                work=(rng.integers(1, 4, b) * active).astype(np.int32),
                q_user=q_user, q_t=q_t, q_head=np.int32(head), q_size=np.int32(size),
                dropped=np.int32(rng.integers(0, 5)), completed=np.int32(rng.integers(0, 5)),
                shed=np.int32(rng.integers(0, 5)))


def test_queueing_core_matches_reference(jx):
    """enqueue -> admit (with and without a shed gate) -> tick from 300
    random states, each op from the same state in both packages."""
    jax, jb, jnp = jx["jax"], jx["batcher"], jx["jnp"]
    rng = np.random.default_rng(0)
    seen = dict(dropped=0, shed=0, full=0, popped=0, done=0)
    # the reference's scans compiled once a shape (their eager dispatch
    # traces them anew at every call)
    ref = dict(enqueue=jax.jit(jb.enqueue, static_argnums=3), admit=jax.jit(jb.admit),
               tick=jax.jit(jb.tick))
    shapes = [(1, 1, 1), (3, 2, 5), (4, 8, 6), (8, 11, 3), (6, 4, 8)]
    for case in range(300):
        (b, q, u), k = shapes[case % len(shapes)], 3
        fields = _random_state(rng, b, q, u)
        jstate = jb.BatchState(**{f: jnp.asarray(v) for f, v in fields.items()})
        state = BatchState(**{f: _t(v) for f, v in fields.items()})
        counts = rng.integers(0, k + 1, u).astype(np.int32)
        now = np.float32(rng.uniform(1, 2))
        service = rng.uniform(0, 1, u).astype(np.float32)
        work = rng.integers(1, 5, u).astype(np.int32)
        shed = rng.random(u) < 0.3 if case % 2 else None
        jst = ref["enqueue"](jstate, jnp.asarray(counts), jnp.float32(now), k)
        st = batcherlib.enqueue(state, _t(counts), _t(now), k)
        _assert_tuple(st, jst)
        seen["dropped"] += int(jst.dropped) > int(jstate.dropped)
        seen["full"] += int(jst.q_size) == q
        jst2 = ref["admit"](jst, jnp.float32(now), jnp.asarray(service), jnp.asarray(work),
                            shed=None if shed is None else jnp.asarray(shed))
        st2 = batcherlib.admit(BatchState(*(_t(x) for x in jst)), _t(now), _t(service), _t(work),
                               shed=None if shed is None else _t(shed))
        _assert_tuple(st2, jst2)
        seen["shed"] += int(jst2.shed) > int(jst.shed)
        seen["popped"] += int(jst2.q_size) < int(jst.q_size)
        jst3, jcomp = ref["tick"](jst2)
        st3, comp = batcherlib.tick(BatchState(*(_t(x) for x in jst2)))
        _assert_tuple(st3, jst3)
        _assert_tuple(comp, jcomp)
        seen["done"] += int(jcomp.valid.sum()) > 0
        assert int(batcherlib.occupancy(st3)) == int(jb.occupancy(jst3))
        assert int(batcherlib.backlog(st3)) == int(jb.backlog(jst3))
    assert min(seen.values()) > 10, seen


# -- telemetry (tests/test_online.py) -----------------------------------------------
def _obs(prof, comp, s, congestion, rate_up=1e6, rate_dn=1e6, r=4.0):
    f = prof.n_layers
    on_dev = torch.arange(f) < s
    edge_speed = lam(torch.tensor(r), comp) * comp.c_min_edge
    t_layer = torch.where(on_dev, prof.fl / comp.c_device, prof.fl * congestion / edge_speed)
    return Observation(t_layer=t_layer, t_up=prof.w[s] / rate_up,
                       rate_up=torch.tensor(rate_up), rate_dn=torch.tensor(rate_dn),
                       r_units=torch.tensor(r))


def test_telemetry_congestion_flows_into_m_down_not_fl():
    prof, comp = profiles.nin(), ComputeConstants()
    tel = Telemetry(prof, comp, decay=0.0)
    state = tel.update(tel.init(), torch.tensor(3, dtype=torch.int32),
                       _obs(prof, comp, 3, congestion=10.0))
    np.testing.assert_allclose(state.fl.numpy(), prof.fl.numpy(), rtol=1e-5)
    assert float(state.kappa) == pytest.approx(10.0, rel=1e-5)
    extra = (tel.profile(state).m_down - prof.m_down).numpy()
    assert extra[0] > extra[5] > extra[-1] == 0.0
    state = tel.update(state, torch.tensor(3), _obs(prof, comp, 3, congestion=1.0))
    assert float(state.kappa) == pytest.approx(1.0, rel=1e-5)


def test_telemetry_ema_and_upload_repricing():
    prof, comp = profiles.nin(), ComputeConstants()
    tel = Telemetry(prof, comp, decay=0.5)
    state = tel.init()
    s = 4
    slow = _obs(prof, comp, s, congestion=1.0)
    slow = slow._replace(t_up=2.0 * prof.w[s] / slow.rate_up)
    for _ in range(20):
        state = tel.update(state, torch.tensor(s), slow)
    w = state.w.numpy()
    assert w[s] == pytest.approx(2.0 * float(prof.w[s]), rel=1e-3)
    np.testing.assert_allclose(np.delete(w, s), np.delete(prof.w.numpy(), s), rtol=1e-6)
    assert int(state.updates) == 20
    with pytest.raises(ValueError):
        Telemetry(prof, comp, decay=1.0)


def test_telemetry_profile_is_planner_compatible():
    prof, comp = profiles.nin(), ComputeConstants()
    tel = Telemetry(prof, comp)
    state = tel.init()
    mp0 = tel.profile(state)
    prof.validate_like(mp0)
    mp1 = tel.profile(tel.update(state, torch.tensor(2), _obs(prof, comp, 2, congestion=7.0)))
    for f in ("fl", "w", "m_down"):
        a, b = getattr(mp0, f), getattr(mp1, f)
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert mp1.name == prof.name


def test_profile_validation_errors_are_specific():
    prof, other = profiles.nin(), profiles.vgg16()
    with pytest.raises(ProfileShapeError, match="layers"):
        prof.validate_like(other)
    with pytest.raises(ProfileShapeError, match="name"):
        prof.validate_like(dataclasses.replace(prof, name="nin-measured"))
    with pytest.raises(ProfileShapeError, match="fl"):
        prof.validate_like(dataclasses.replace(prof, fl=prof.fl.half()))
    fixed = prof.like(prof.fl.half(), prof.w, prof.m_down)
    assert fixed.fl.dtype == prof.fl.dtype and fixed.name == prof.name
    with pytest.raises(ProfileShapeError):
        Telemetry(prof, ComputeConstants()).init(other)


def test_telemetry_matches_reference(jx):
    """Forty updates of random observations at random splits (and NaN /
    spiked ones) from the same state in both packages, and the measured
    profile rebuilt from each."""
    jtel, jnp = jx["telemetry"], jx["jnp"]
    jprof, prof = jx["profiles"].nin(), profiles.nin()
    comp = ComputeConstants()
    f = prof.n_layers
    rng = np.random.default_rng(1)
    for decay in (0.9, 0.0):
        jt = jtel.Telemetry(jprof, jx["Comp"](), decay)
        jstate = jt.init()
        for step in range(40):
            s = np.int32(rng.integers(0, f + 1))
            obs = dict(t_layer=rng.uniform(1e-4, 1e-2, f).astype(np.float32),
                       t_up=np.float32(rng.uniform(1e-3, 1e-1)),
                       rate_up=np.float32(rng.uniform(1e5, 1e7)),
                       rate_dn=np.float32(rng.uniform(1e5, 1e7)),
                       r_units=np.float32(rng.uniform(1, 16)))
            if step == 30:
                obs["t_layer"] = obs["t_layer"] * np.float32(50.0)
            state = tellib.TelemetryState(*(_t(x) for x in jstate))
            new = tellib.telemetry_update(comp, decay, prof.fl, state, _t(s),
                                          Observation(**{k: _t(v) for k, v in obs.items()}))
            jstate = jtel.telemetry_update(jx["Comp"](), decay, jprof.fl, jstate, jnp.int32(s),
                                           jtel.Observation(**{k: jnp.asarray(v)
                                                               for k, v in obs.items()}))
            for name, a, b in zip(new._fields, new, jstate):
                b = np.asarray(b)
                scale = np.maximum(np.abs(b), np.abs(a.numpy()))
                assert np.all(np.abs(a.numpy() - b) <= 1e-5 * scale), (decay, step, name)
            want = jtel.measured_profile(jx["Comp"](), jprof, jstate)
            got = tellib.measured_profile(comp, prof, tellib.TelemetryState(*(_t(x)
                                                                              for x in jstate)))
            # m_down's congestion term is (total - prefix[s]) * ...: its
            # scale is that of the total, not of the difference.
            js = {k: np.asarray(v, np.float64) for k, v in jstate._asdict().items()}
            speed = max(float(np.power(js["r_units"], comp.lam_exponent)) * comp.c_min_edge, 1.0)
            congestion_scale = (np.sum(np.abs(js["fl"])) * abs(js["kappa"] - 1.0) / speed
                                * abs(js["rate_dn"]))
            for name in ("fl", "w", "m_down"):
                a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
                scale = np.abs(b) + (congestion_scale if name == "m_down" else 0.0)
                assert np.all(np.abs(a - b) <= 1e-5 * scale), (decay, step, name)
        # a dropped sample: NaN flows into the unguarded state in both
        nan_obs = {k: np.float32(np.nan) for k in ("t_up", "rate_up", "rate_dn", "r_units")}
        nan_obs["t_layer"] = np.full(f, np.nan, np.float32)
        got = tellib.telemetry_update(comp, decay, prof.fl,
                                      tellib.TelemetryState(*(_t(x) for x in jstate)), _t(s),
                                      Observation(**{k: _t(v) for k, v in nan_obs.items()}))
        want = jtel.telemetry_update(jx["Comp"](), decay, jprof.fl, jstate, jnp.int32(s),
                                     jtel.Observation(**{k: jnp.asarray(v)
                                                         for k, v in nan_obs.items()}))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(np.asarray(b)))


# -- qos (tests/test_online.py) --------------------------------------------------
def _complete(latencies, users=None):
    lat = torch.tensor(latencies, dtype=torch.float32)
    b = lat.shape[0]
    return Completions(valid=torch.ones(b, dtype=torch.bool),
                       user=torch.zeros(b, dtype=torch.int32) if users is None
                       else torch.tensor(users, dtype=torch.int32),
                       latency=lat, wait=torch.zeros(b), serv=lat)


def test_qos_percentiles_match_numpy():
    cfg = QosConfig(window=64, p95_max_s=1e9, p50_max_s=1e9, miss_rate_max=1.1)
    mon = QosMonitor(cfg, 2, device="cpu")
    state = mon.init()
    rng = np.random.default_rng(0)
    seen = []
    for _ in range(6):
        lats = rng.uniform(0.01, 0.9, size=5)
        seen.extend(lats)
        state, rep = mon.update(state, _complete(lats))
    ranked = np.sort(np.asarray(seen, np.float32))
    n = len(seen)
    assert float(rep.p50) == pytest.approx(ranked[int(round(0.50 * (n - 1)))], rel=1e-5)
    assert float(rep.p95) == pytest.approx(ranked[int(round(0.95 * (n - 1)))], rel=1e-5)
    assert not bool(rep.trigger)


def test_qos_trigger_fires_and_cools_down():
    cfg = QosConfig(deadline_s=0.1, p95_max_s=0.2, p50_max_s=0.15, miss_rate_max=0.5,
                    window=16, cooldown_epochs=3)
    mon = QosMonitor(cfg, 4, device="cpu")
    state, rep = mon.update(mon.init(), _complete([0.01, 0.02, 0.03]))
    assert not bool(rep.trigger)
    state, rep = mon.update(state, _complete([0.9, 0.8, 0.95]))
    assert bool(rep.trigger)
    for _ in range(2):
        state, rep = mon.update(state, _complete([0.9, 0.8, 0.95]))
        assert not bool(rep.trigger)
    for _ in range(2):
        state, rep = mon.update(state, _complete([0.9, 0.8, 0.95]))
    assert int(state.triggers) >= 2 and int(state.missed) > 0
    state, _ = mon.update(state, _complete([0.9], users=[2]))
    assert float(state.miss[2]) > 0.0
    with pytest.raises(ValueError):
        QosMonitor(QosConfig(window=1), 2, device="cpu")


@pytest.mark.parametrize("guard", [False, True])
def test_qos_matches_reference(jx, guard):
    """Sixty epochs of random completions through both monitors from the
    same state: a window of 4 behind 6 slots (the ring overflows within an
    epoch), repeated users, NaN / inf latencies."""
    jq, jnp = jx["qos"], jx["jnp"]
    kw = dict(deadline_s=0.2, p95_max_s=0.3, p50_max_s=0.15, miss_rate_max=0.4, window=4,
              cooldown_epochs=2, guard_nonfinite=guard)
    cfg, jcfg = QosConfig(**kw), jq.QosConfig(**kw)
    u, b = 3, 6
    jstate = jq.QosMonitor(jcfg, u).init()
    ref = jx["jax"].jit(lambda st, c: jq.qos_update(jcfg, st, c))
    rng = np.random.default_rng(2)
    fired = twice = 0
    for epoch in range(60):
        valid = rng.random(b) < 0.6
        users = np.where(valid, rng.integers(0, u, b), -1).astype(np.int32)
        lat = rng.uniform(0.01, 0.5, b).astype(np.float32)
        if epoch % 7 == 3:
            lat[rng.integers(0, b)] = np.nan
        if epoch % 11 == 5:
            lat[rng.integers(0, b)] = np.inf
        lat = np.where(valid, lat, 0.0).astype(np.float32)
        twice += int(np.max(np.bincount(users[valid], minlength=u), initial=0) > 1)
        comp = dict(valid=valid, user=users, latency=lat, wait=np.zeros(b, np.float32),
                    serv=lat)
        state = qoslib.QosState(*(_t(x) for x in jstate))
        new, rep = qoslib.qos_update(cfg, state, Completions(**{k: _t(v) for k, v in
                                                                comp.items()}))
        jstate, jrep = ref(jstate, jq.Completions(**{k: jnp.asarray(v) for k, v
                                                                      in comp.items()}))
        for got, want in ((new, jstate), (rep, jrep)):
            for name, a, w in zip(got._fields, got, want):
                a, w = a.numpy(), np.asarray(w)
                if w.dtype.kind in "biu":
                    np.testing.assert_array_equal(a, w, err_msg=name)
                else:
                    np.testing.assert_allclose(a, w, rtol=0, atol=1e-6, err_msg=name)
        fired += bool(jrep.trigger)
    assert fired > 2 and twice > 5


# -- the service-time cast ---------------------------------------------------------
def test_work_epochs_saturates_like_the_reference(jx):
    """The reference's jnp.clip(jnp.ceil(service / dt).astype(int32), 1,
    max_work_epochs): NaN -> 0 -> 1 epoch, +inf and values past 2^31 ->
    the cap, -inf -> 1. A plain float-to-int32 cast in PyTorch would give
    INT32_MIN, i.e. 1 epoch, for a blacked-out user's ~1e15 s."""
    jnp = jx["jnp"]
    dt = 0.02
    service = np.array([np.nan, np.inf, -np.inf, 1e15, 3e9 * dt, 2 ** 31 * dt, 0.5 * dt, dt,
                        dt * 1.0001, 0.0, -1.0, 3.999 * dt, 199.5 * dt, 250.0 * dt],
                       np.float32)
    for cap in (200, 1000, 2 ** 31 - 1):
        want = np.asarray(jnp.clip(jnp.ceil(jnp.asarray(service) / dt).astype(jnp.int32), 1, cap))
        got = work_epochs(_t(service), dt, cap)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert work_epochs(_t(service), dt, 200).tolist()[:4] == [1, 200, 1, 200]
