"""The port's faults package (injectors, guards, degradation ladder,
fallback plan) alone and against the JAX package, on the CPU.

  * the JAX package's tests/test_faults.py cases for the injectors, the
    guards, the ladder and the fallback plan, on the port;
  * fault_step fed the reference's uniforms (its key split into seven, a
    Bernoulli(p) being uniform < p): the same masks, epoch after epoch
    (booleans, so exact), and the same service multipliers;
  * apply_env_faults / corrupt_observation / spike_service on the same
    draws: gains and values exactly equal (the same float32 products and
    selects);
  * the telemetry, observation and service guard words on corrupted
    reference states: the same ints as the JAX guards (exact);
  * the ladder driven through one sequence of health words and replan
    outcomes in both packages: equal export_state() after every step (it is
    the same pure-Python state machine);
  * the fallback plan's T and E within 1e-5 of the reference's on the same
    env (float32 rates summed in another order), its discrete fields
    exactly, and its dtypes and shapes leaf for leaf those of the engine's
    own plan."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import GdConfig, make_env, make_weights, profiles  # noqa: E402
from repro_torch.core.types import GdVars, SplitPlan  # noqa: E402
from repro_torch.core.utility import delay_energy  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    PLAN_MASK,
    TELEMETRY_MASK,
    DegradeLadder,
    EpochWatchdog,
    FaultConfig,
    LadderConfig,
    apply_env_faults,
    corrupt_observation,
    decode_health,
    fallback_plan,
    fault_step,
    init_fault_state,
    observation_health,
    pack_health,
    plan_health,
    service_health,
    spike_service,
    telemetry_health,
    tree_select,
)
from repro_torch.faults import injectors  # noqa: E402
from repro_torch.online.telemetry import Observation, Telemetry  # noqa: E402
from repro_torch.planning import PlannerEngine  # noqa: E402

# The JAX package's tests/test_faults.py configs.
ADAM_CFG = dict(step_size=3e-2, eps=1e-4, max_iters=40, optimizer="adam")
CHAOS = dict(link_outage_rate=0.2, fade_depth=1e-6, ap_outage_rate=0.05,
             telemetry_drop_rate=0.1, telemetry_spike_rate=0.05, service_spike_rate=0.02)
CHAOS_CFG = FaultConfig(**CHAOS)
SHAPES = {"link_fail": "u", "link_recover": "u", "ap_fail": "n", "ap_recover": "n",
          "tel_drop": "", "tel_spike": "", "svc_spike": "u"}


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from repro.core import channel as jchannel
    from repro.core import make_weights as jmake_weights
    from repro.core import profiles as jprofiles
    from repro.faults import degrade as jdegrade
    from repro.faults import guards as jguards
    from repro.faults import injectors as jinjectors
    from repro.online import telemetry as jtelemetry
    return dict(jax=jax, channel=jchannel, make_weights=jmake_weights, profiles=jprofiles,
                degrade=jdegrade, guards=jguards, injectors=jinjectors, telemetry=jtelemetry)


def _env(u=6, n=2, m=3, seed=0):
    return make_env(u, n, m, seed=seed, device="cpu")


def _t(x):
    return torch.tensor(np.asarray(x))


def _ref_draws(jax, key, u, n):
    """The uniforms behind the reference's fault_step(rates, key, state)."""
    keys = jax.random.split(key, 7)
    dims = {"u": (u,), "n": (n,), "": ()}
    return {name: _t(jax.random.uniform(k, dims[SHAPES[name]]))
            for name, k in zip(injectors.DRAW_KEYS, keys)}


def _port_env(jenv):
    return convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp, device="cpu")


# -- the injectors (tests/test_faults.py TestInjectors) ------------------------
def test_deterministic_from_seed():
    rates = CHAOS_CFG.rates("cpu")
    st = init_fault_state(6, 2, "cpu")
    outs = [fault_step(rates, torch.Generator().manual_seed(42), st) for _ in range(2)]
    for a, b in zip(outs[0][0] + outs[0][1], outs[1][0] + outs[1][1]):
        assert torch.equal(a, b)


def test_zero_config_is_identity():
    rates = FaultConfig().rates("cpu")
    st, draw = fault_step(rates, torch.Generator().manual_seed(0), init_fault_state(6, 2, "cpu"))
    assert not bool(draw.link_down.any()) and not bool(draw.ap_down.any())
    assert not bool(draw.tel_drop) and not bool(draw.tel_spike)
    env = _env()
    env2 = apply_env_faults(env, draw, rates)
    assert torch.equal(env.g_up, env2.g_up) and torch.equal(env.g_dn, env2.g_dn)
    svc = torch.ones(6)
    assert torch.equal(spike_service(svc, draw), svc)


def test_markov_outage_persists():
    rates = FaultConfig(link_outage_rate=0.3, link_mean_epochs=50.0).rates("cpu")
    st = init_fault_state(64, 2, "cpu")
    stays = total = 0
    for i in range(60):
        prev = st.link_down
        st, _ = fault_step(rates, torch.Generator().manual_seed(1000 + i), st)
        stays += int(torch.sum(prev & st.link_down))
        total += int(torch.sum(prev))
    assert total > 0
    assert stays / total > 0.9      # recover prob is 1/50


def test_stationary_outage_fraction():
    rates = FaultConfig(link_outage_rate=0.2, link_mean_epochs=8.0).rates("cpu")
    st = init_fault_state(256, 2, "cpu")
    frac = []
    for i in range(300):
        st, _ = fault_step(rates, torch.Generator().manual_seed(2000 + i), st)
        if i >= 50:                  # past burn-in
            frac.append(float(st.link_down.float().mean()))
    assert abs(sum(frac) / len(frac) - 0.2) < 0.05


def test_ap_blackout_zeroes_cell():
    rates = CHAOS_CFG.rates("cpu")
    _, draw = fault_step(rates, torch.Generator().manual_seed(0), init_fault_state(6, 2, "cpu"))
    draw = draw._replace(ap_down=torch.tensor([True, False]),
                         link_down=torch.zeros(6, dtype=torch.bool))
    env = apply_env_faults(_env(), draw, rates)
    assert bool((env.g_up[:, 0, :] == 0.0).all()) and bool((env.g_dn[0] == 0.0).all())
    assert bool((env.g_up[:, 1, :] > 0.0).all())


def test_corrupt_observation_drop_and_spike():
    obs = Observation(t_layer=torch.ones(4), t_up=torch.tensor(1.0),
                      rate_up=torch.tensor(1e6), rate_dn=torch.tensor(1e6),
                      r_units=torch.tensor(2.0))
    rates = CHAOS_CFG.rates("cpu")
    _, draw = fault_step(rates, torch.Generator().manual_seed(0), init_fault_state(6, 2, "cpu"))
    dropped = corrupt_observation(obs, draw._replace(tel_drop=torch.tensor(True),
                                                     tel_spike=torch.tensor(False)), rates)
    assert bool(torch.isnan(dropped.t_layer).all()) and bool(torch.isnan(dropped.t_up))
    spiked = corrupt_observation(obs, draw._replace(tel_drop=torch.tensor(False),
                                                    tel_spike=torch.tensor(True)), rates)
    assert torch.allclose(spiked.t_layer, obs.t_layer * CHAOS_CFG.telemetry_spike_scale)


def test_rates_are_float32_scalars_on_the_device():
    rates = CHAOS_CFG.rates("cpu")
    assert all(r.dtype == torch.float32 and r.shape == () for r in rates)


# -- the injectors against the reference ----------------------------------------
def test_rates_match_reference(jx):
    for cfg in (FaultConfig(), CHAOS_CFG, FaultConfig(link_outage_rate=0.999,
                                                     ap_outage_rate=2.0, ap_mean_epochs=0.5)):
        want = jx["injectors"].FaultConfig(**dataclasses.asdict(cfg)).rates()
        got = cfg.rates("cpu")
        assert got._fields == want._fields
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fault_step_on_reference_draws(jx):
    """Twenty epochs of the chaos mix (and a harsher one) threaded through
    both packages' fault_step on the reference's uniforms."""
    jax, jinj = jx["jax"], jx["injectors"]
    u, n = 40, 4
    for cfg in (CHAOS_CFG, FaultConfig(link_outage_rate=0.5, link_mean_epochs=2.0,
                                       ap_outage_rate=0.4, ap_mean_epochs=2.0,
                                       telemetry_drop_rate=0.5, telemetry_spike_rate=0.5,
                                       service_spike_rate=0.5)):
        jrates = jinj.FaultConfig(**dataclasses.asdict(cfg)).rates()
        rates = cfg.rates("cpu")
        jst, st = jinj.init_fault_state(u, n), init_fault_state(u, n, "cpu")
        fired = np.zeros(5, int)
        for t in range(20):
            key = jax.random.fold_in(jax.random.PRNGKey(7), t)
            jst, jdraw = jinj.fault_step(jrates, key, jst)
            st, draw = injectors.fault_step_from(rates, _ref_draws(jax, key, u, n), st)
            for a, b in zip(st + draw, jst + jdraw):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            fired += [int(draw.link_down.sum()), int(draw.ap_down.sum()), int(draw.tel_drop),
                      int(draw.tel_spike), int((draw.svc_mult > 1).sum())]
        assert (fired > 0).all(), fired                   # every process fired


def test_env_observation_and_service_faults_match_reference(jx):
    jax, jinj = jx["jax"], jx["injectors"]
    jenv = jx["channel"].make_env(jax.random.PRNGKey(3), n_users=6, n_aps=2, n_sub=3)
    env = _port_env(jenv)
    jrates, rates = jinj.FaultConfig(**CHAOS).rates(), CHAOS_CFG.rates("cpu")
    _, jdraw = jinj.fault_step(jrates, jax.random.PRNGKey(0), jinj.init_fault_state(6, 2))
    jobs = jx["telemetry"].Observation(
        t_layer=jax.numpy.linspace(0.1, 1.0, 5), t_up=jax.numpy.float32(0.3),
        rate_up=jax.numpy.float32(1e6), rate_dn=jax.numpy.float32(2e6),
        r_units=jax.numpy.float32(2.0))
    obs = Observation(*(_t(x) for x in jobs))
    svc = jax.numpy.linspace(0.01, 0.6, 6)
    for link, ap, drop, spike in ((0b100101, 0b01, False, True), (0b010000, 0b10, True, False),
                                  (0, 0, True, True), (0b111111, 0b11, False, False)):
        jd = jdraw._replace(
            link_down=jax.numpy.array([bool(link >> i & 1) for i in range(6)]),
            ap_down=jax.numpy.array([bool(ap >> i & 1) for i in range(2)]),
            tel_drop=jax.numpy.bool_(drop), tel_spike=jax.numpy.bool_(spike),
            svc_mult=jax.numpy.where(jax.numpy.arange(6) % 2 == 0, 10.0, 1.0))
        d = injectors.FaultDraw(*(_t(x) for x in jd))
        want = jinj.apply_env_faults(jenv, jd, jrates)
        got = apply_env_faults(env, d, rates)
        np.testing.assert_array_equal(got.g_up.numpy(), np.asarray(want.g_up))
        np.testing.assert_array_equal(got.g_dn.numpy(), np.asarray(want.g_dn))
        wo, go = jinj.corrupt_observation(jobs, jd, jrates), corrupt_observation(obs, d, rates)
        for a, b in zip(go, wo):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(spike_service(_t(svc), d).numpy(),
                                      np.asarray(jinj.spike_service(svc, jd)))


# -- the guards (tests/test_faults.py TestGuards) ---------------------------------
def _plan():
    env = _env()
    return PlannerEngine(profiles.nin(), cfg=GdConfig(**ADAM_CFG), device="cpu").plan(env).plan, env


def _health(plan, env):
    return int(plan_health(plan, n_sub=env.n_sub, p_up_max=env.radio.p_up_max_w,
                           p_dn_max=env.radio.p_dn_max_w, r_max=env.comp.r_max))


def test_clean_and_corrupt_plans():
    plan, env = _plan()
    assert _health(plan, env) == 0
    h = _health(dataclasses.replace(plan, utility=torch.tensor(float("nan"))), env)
    assert h & PLAN_MASK and decode_health(h)["plan_utility"]
    p_up = plan.p_up.clone()
    p_up[0] = 10.0 * env.radio.p_up_max_w
    assert decode_health(_health(dataclasses.replace(plan, p_up=p_up), env))["plan_power"]


def test_telemetry_health_bits():
    tel = Telemetry(profiles.nin(), _env().comp, decay=0.5)
    ts = tel.init()
    assert int(telemetry_health(ts, kappa_max=100.0)) == 0
    fl = ts.fl.clone()
    fl[0] = float("nan")
    h = int(telemetry_health(ts._replace(fl=fl), kappa_max=100.0))
    assert h & TELEMETRY_MASK and decode_health(h)["profile"]
    hot = ts._replace(kappa=torch.tensor(1e4))
    assert decode_health(int(telemetry_health(hot, 100.0)))["kappa"]


def test_guard_words_match_reference(jx):
    """Each guard on the reference's telemetry state and observation,
    clean and corrupted one field at a time: the same int32 words, and
    tree_select / pack_health / decode_health agree."""
    jg, jtel = jx["guards"], jx["telemetry"]
    jnp = jx["jax"].numpy
    jts = jtel.Telemetry(jx["profiles"].nin(), jx["channel"].make_env(
        jx["jax"].random.PRNGKey(0), 6, 2, 3).comp).init()
    jobs = jtel.Observation(t_layer=jnp.linspace(0.1, 1.0, 9), t_up=jnp.float32(0.3),
                            rate_up=jnp.float32(1e6), rate_dn=jnp.float32(2e6),
                            r_units=jnp.float32(2.0))
    nan, inf = jnp.float32(jnp.nan), jnp.float32(jnp.inf)
    states = [jts, jts._replace(fl=jts.fl.at[3].set(nan)), jts._replace(w=jts.w.at[0].set(inf)),
              jts._replace(m_down=jts.m_down.at[1].set(nan)), jts._replace(rate_dn=nan),
              jts._replace(r_units=-inf), jts._replace(kappa=jnp.float32(100.0)),
              jts._replace(kappa=jnp.float32(100.01)), jts._replace(kappa=nan)]
    observations = [jobs, jobs._replace(t_layer=jobs.t_layer.at[8].set(nan)),
                    jobs._replace(t_up=inf), jobs._replace(rate_up=nan),
                    jobs._replace(rate_dn=-inf), jobs._replace(r_units=nan)]
    seen = set()
    for js in states:
        ts = type(Telemetry(profiles.nin(), _env().comp).init())(*(_t(x) for x in js))
        got = telemetry_health(ts, 100.0)
        assert got.dtype == torch.int32
        assert int(got) == int(jg.telemetry_health(js, 100.0))
        seen.add(int(got))
    for jo in observations:
        got = observation_health(Observation(*(_t(x) for x in jo)))
        assert int(got) == int(jg.observation_health(jo))
        seen.add(int(got))
    for svc in (jnp.ones(6), jnp.ones(6).at[2].set(nan), jnp.ones(6).at[5].set(inf)):
        assert int(service_health(_t(svc))) == int(jg.service_health(svc))
        seen.add(int(service_health(_t(svc))))
    assert seen == {0, 16, 32, 64, 128}
    words = [torch.tensor(w, dtype=torch.int32) for w in (16, 64, 128, 1)]
    want = int(jg.pack_health(*(jnp.int32(int(w)) for w in words)))
    assert int(pack_health(*words)) == want == 209
    assert decode_health(want) == jg.decode_health(want)
    assert TELEMETRY_MASK == jg.TELEMETRY_MASK
    new = Observation(*(_t(x) for x in observations[1]))
    old = Observation(*(_t(x) for x in jobs))
    for keep in (True, False):
        sel = tree_select(torch.tensor(keep), new, old)
        jsel = jg.tree_select(jnp.bool_(keep), observations[1], jobs)
        for a, b in zip(sel, jsel):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the ladder (tests/test_faults.py TestLadder) -----------------------------------
def test_escalation_order_and_backoff():
    lad = DegradeLadder(LadderConfig(baseline_after=2, backoff_base=2, backoff_max=8))
    assert lad.stage == "normal"
    lad.pre_replan(0)
    lad.post_replan(plan_ok=False, replanned=True)
    assert lad.stage == "hold" and not lad.serve_fallback
    d = lad.pre_replan(0)
    assert d.hold and not d.force
    d = lad.pre_replan(0)
    assert d.force and d.force_cold
    lad.post_replan(plan_ok=False, replanned=True)
    assert lad.stage == "baseline" and lad.serve_fallback
    assert lad.backoff == 8
    lad.post_replan(plan_ok=False, replanned=True)
    assert lad.backoff == 8


def test_recovery_counts_epochs():
    lad = DegradeLadder(LadderConfig(baseline_after=2, recover_after=1, backoff_base=1))
    lad.pre_replan(0)
    lad.post_replan(plan_ok=False, replanned=True)
    lad.pre_replan(0)
    lad.pre_replan(0)
    lad.post_replan(plan_ok=True, replanned=True)
    assert lad.stage == "normal"
    m = lad.metrics()
    assert m["recoveries"] == 1 and m["mean_recovery_epochs"] == 2.0
    assert lad.backoff == 1


def test_held_epochs_carry_no_evidence():
    lad = DegradeLadder(LadderConfig())
    lad.pre_replan(0)
    lad.post_replan(plan_ok=None, replanned=False)
    assert lad.stage == "normal" and lad.bad_streak == 0


def test_quarantine_countdown():
    lad = DegradeLadder(LadderConfig(quarantine_epochs=3))
    assert not lad.pre_replan(TELEMETRY_MASK).use_measured
    assert lad.metrics()["quarantines"] == 1
    for _ in range(3):
        d = lad.pre_replan(0)
    assert d.use_measured
    lad.pre_replan(TELEMETRY_MASK)
    lad.pre_replan(TELEMETRY_MASK)
    assert lad.metrics()["quarantines"] == 2


def test_timeout_escalates_without_plan_evidence():
    lad = DegradeLadder(LadderConfig(backoff_base=2))
    lad.on_timeout()
    assert lad.stage == "hold" and lad.metrics()["watchdog_fires"] == 1
    with pytest.raises(ValueError):
        LadderConfig(fallback="pray")
    with pytest.raises(ValueError):
        LadderConfig(baseline_after=0)


def test_epoch_watchdog_reports_instead_of_raising():
    import time
    wd = EpochWatchdog(0.01)
    out, fired = wd.guard(lambda: (time.sleep(0.05), 7)[1])
    assert (out, fired, wd.fires) == (7, True, 1)
    assert EpochWatchdog(0.0).guard(lambda: 3) == (3, False)


def test_ladder_matches_reference_step_by_step(jx):
    """One scripted sequence of health words, replan outcomes and timeouts
    through both ladders (three configs): equal decisions, serve_fallback
    and export_state() after every step, and the import round trip."""
    jd = jx["degrade"]
    rng = np.random.default_rng(5)
    script = []
    for _ in range(120):
        health = int(rng.choice([0, 0, 0, 16, 32, 64, 128, 1, 80]))
        replanned = bool(rng.random() < 0.6)
        ok = None if not replanned else bool(rng.random() < 0.5)
        script.append((health, replanned, ok, bool(rng.random() < 0.05)))
    for kw in (dict(), dict(quarantine_epochs=15, baseline_after=2),
               dict(baseline_after=1, recover_after=3, backoff_base=1, backoff_max=4)):
        ours, ref = DegradeLadder(LadderConfig(**kw)), jd.DegradeLadder(jd.LadderConfig(**kw))
        for health, replanned, ok, timeout in script:
            assert tuple(ours.pre_replan(health)) == tuple(ref.pre_replan(health))
            ours.post_replan(ok, replanned)
            ref.post_replan(ok, replanned)
            if timeout:
                ours.on_timeout()
                ref.on_timeout()
            assert ours.export_state() == ref.export_state()
            assert ours.serve_fallback == ref.serve_fallback
        assert ours.metrics() == ref.metrics()
        back = DegradeLadder(LadderConfig(**kw))
        back.import_state(ref.export_state())
        assert back.export_state() == ref.export_state()


# -- the fallback plan (tests/test_faults.py TestFallbackPlan) -------------------
def test_fallback_finite_under_total_blackout():
    env = _env()
    dead = dataclasses.replace(env, g_up=torch.zeros_like(env.g_up),
                               g_dn=torch.zeros_like(env.g_dn))
    prof = profiles.nin()
    w = make_weights(env.n_users, device="cpu")
    plan = fallback_plan(dead, prof, w, mode="device_only")
    assert bool(torch.isfinite(plan.utility)) and int(plan.s) == prof.n_layers
    plan = fallback_plan(env, prof, w, mode="edge_only")
    assert bool(torch.isfinite(plan.utility)) and int(plan.s) == 0
    with pytest.raises(ValueError):
        fallback_plan(env, prof, w, mode="pray")


def test_fallback_dtypes_and_shapes_equal_the_engine_plan():
    env = _env()
    template = PlannerEngine(profiles.nin(), cfg=GdConfig(**ADAM_CFG), device="cpu").plan(env).plan
    w = make_weights(env.n_users, device="cpu")
    for mode in ("device_only", "edge_only"):
        for tmpl in (None, template):
            fb = fallback_plan(env, profiles.nin(), w, template=tmpl, mode=mode)
            for f in dataclasses.fields(SplitPlan):
                a, b = getattr(fb, f.name), getattr(template, f.name)
                assert (a.dtype, tuple(a.shape), a.device) == (b.dtype, tuple(b.shape),
                                                               b.device), f.name


@pytest.mark.parametrize("mode", ["device_only", "edge_only"])
def test_fallback_matches_reference(jx, mode):
    """The fallback plan on the reference's env, healthy and blacked out:
    the same discrete fields, its utility and its T and E within 1e-5."""
    jax = jx["jax"]
    jenv = jx["channel"].make_env(jax.random.PRNGKey(4), n_users=12, n_aps=3, n_sub=5)
    jrates = jx["injectors"].FaultConfig(**CHAOS).rates()
    _, jdraw = jx["injectors"].fault_step(jrates, jax.random.PRNGKey(0),
                                          jx["injectors"].init_fault_state(12, 3))
    jdraw = jdraw._replace(ap_down=jax.numpy.array([True, False, False]),
                           link_down=jax.numpy.arange(12) % 4 == 1)
    from repro.core.types import GdVars as JGdVars
    from repro.core.utility import delay_energy as jdelay_energy
    jprof, prof = jx["profiles"].nin(), profiles.nin()
    for masked in (False, True):
        je = jx["injectors"].apply_env_faults(jenv, jdraw, jrates) if masked else jenv
        env = _port_env(je)
        want = jx["degrade"].fallback_plan(je, jprof, jx["make_weights"](12), mode=mode)
        got = fallback_plan(env, prof, make_weights(12, device="cpu"), mode=mode)
        for f in ("s", "sub_up", "sub_dn", "iters", "rounding_violations", "p_up", "p_dn", "r"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(float(got.utility), float(want.utility), rtol=1e-5)
        np.testing.assert_allclose(got.per_layer_utility.numpy(),
                                   np.asarray(want.per_layer_utility), rtol=1e-5)
        v = GdVars(beta_up=torch.nn.functional.one_hot(got.sub_up.long(), 5).float(),
                   beta_dn=torch.nn.functional.one_hot(got.sub_dn.long(), 5).float(),
                   p_up=got.p_up, p_dn=got.p_dn, r=got.r)
        jv = JGdVars(beta_up=jax.nn.one_hot(want.sub_up, 5), beta_dn=jax.nn.one_hot(want.sub_dn, 5),
                     p_up=want.p_up, p_dn=want.p_dn, r=want.r)
        for a, b in zip(delay_energy(env, prof, int(got.s), v),
                        jdelay_energy(je, jprof, want.s, jv)):
            assert bool(torch.isfinite(a).all())
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
