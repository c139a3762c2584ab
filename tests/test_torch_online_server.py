"""The port's OnlineSplitServer and plan guards, alone and against the JAX
package.

  * the server's schedule, forced and measured replans, cold reset after a
    shape change, NaN-profile rejection (guarded) and pass-through
    (unguarded), and the export_host -> import_host round trip, as the JAX
    package's own tests check them (tests/test_planning_engine.py and
    tests/test_faults.py);
  * plan_health / plan_word on a JAX plan carried across, clean and with
    each bit's corruption: the same ints as the JAX guards (integers, so
    exact);
  * one episode of JAX Scenario envs (carried across) through both servers:
    the same split_layer, recuts, replans, cold_resets and bad_plans after
    every epoch (discrete, so exact; both engines run einsum with Adam);
  * a re-cut's programs on the reduced recurrentgemma-9b give the logits of
    make_split_serve(model, s) and of the unsplit forward to the bit (the
    same functions on the same shapes in the same order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import GdConfig, make_env, profiles  # noqa: E402
from repro_torch.core.types import ProfileShapeError  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.faults import guards  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.planning import PlannerEngine  # noqa: E402
from repro_torch.runtime import OnlineSplitServer, make_split_serve  # noqa: E402
from repro_torch.scenarios import Scenario, ScenarioConfig  # noqa: E402

# The JAX package's test configs: tests/test_planning_engine.py ADAM_CFG and
# tests/test_faults.py ADAM_CFG.
ADAM_CFG = dict(step_size=1e-2, eps=1e-4, max_iters=400, optimizer="adam")
GUARD_CFG = dict(step_size=3e-2, eps=1e-4, max_iters=40, optimizer="adam")
# The episode run through both servers: max_iters cut to keep the JAX side's
# compiles and the port's eager steps within seconds.
EPISODE_CFG = dict(step_size=1e-2, eps=1e-4, max_iters=60, optimizer="adam")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from repro.core import GdConfig as JGdConfig
    from repro.core import make_env as jmake_env
    from repro.core import profiles as jprofiles
    from repro.faults import guards as jguards
    from repro.planning import PlannerEngine as JEngine
    from repro.runtime.serve import OnlineSplitServer as JServer
    from repro.scenarios import Scenario as JScenario
    from repro.scenarios import ScenarioConfig as JScenarioConfig
    return dict(jax=jax, GdConfig=JGdConfig, make_env=jmake_env, profiles=jprofiles,
                guards=jguards, Engine=JEngine, Server=JServer, Scenario=JScenario,
                ScenarioConfig=JScenarioConfig)


def _engine(prof=None, **cfg):
    return PlannerEngine(profiles.nin() if prof is None else prof,
                         cfg=GdConfig(**(cfg or ADAM_CFG)), device="cpu")


def _env(u=8, n=2, m=4, seed=0):
    return make_env(u, n, m, seed=seed, device="cpu")


def _port_env(jenv):
    return convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp, device="cpu")


# -- the server alone (tests/test_planning_engine.py:434-506) ------------------
def test_online_split_server_replan_schedule():
    srv = OnlineSplitServer(_engine(), replan_every=2)
    sc = Scenario(ScenarioConfig(n_users=8, n_aps=2, n_sub=4, fading_rho=0.99,
                                 speed_mps=0.0, arrival_rate_hz=0.0), device="cpu")
    for env in sc.episode(1, 5):
        srv.observe(env)
    assert srv.epoch == 5
    # replans at epochs 0, 2, 4; the first one must have re-cut
    assert srv.state is not None
    assert srv.replans == 3 and srv.forced_replans == 0
    assert 1 <= srv.recuts <= 3
    assert srv.split_layer == int(srv.state.plan.s)
    assert srv.total_iters > 0
    assert srv._iters_acc.device == torch.device("cpu")
    with pytest.raises(ValueError):
        OnlineSplitServer(srv.engine, replan_every=0)
    with pytest.raises(ValueError, match="params=None"):
        OnlineSplitServer(srv.engine, params={})


def test_online_split_server_shape_change_resets_cold():
    """A network shape change mid-serve must not raise: observe() resets the
    warm state and re-plans cold."""
    srv = OnlineSplitServer(_engine(), replan_every=1)
    srv.observe(_env())                                     # (8, 2, 4)
    assert srv.cold_resets == 0
    srv.observe(_env(10, 2, 4, seed=5))                     # U changed
    assert srv.cold_resets == 1
    assert srv.state is not None
    assert tuple(srv.state.norms["beta_up"].shape[1:]) == (10, 4)
    srv.observe(_env(10, 2, 4, seed=6))                     # warm again
    assert srv.cold_resets == 1
    assert srv.epoch == 3
    m = srv.metrics()
    assert m["cold_resets"] == 1 and m["epoch"] == 3
    assert m["replans"] == 3 and m["forced_replans"] == 0
    assert m["split_layer"] == int(srv.state.plan.s)
    assert m["total_iters"] == srv.total_iters > 0


def test_online_split_server_forced_and_measured_replans():
    """Forced replans run off-schedule and are counted apart; a measured
    profile (ModelProfile.like) goes through; a profile of another shape
    raises ProfileShapeError before anything is dispatched or counted."""
    prof = profiles.nin()
    srv = OnlineSplitServer(_engine(prof), replan_every=4)
    env = _env()
    srv.observe(env)                              # epoch 0: scheduled
    srv.observe(env)                              # epoch 1: no replan
    assert srv.metrics()["replans"] == 1 and not srv.last_replanned
    srv.observe(env, force=True)                  # epoch 2: forced
    measured = prof.like(prof.fl * 2.0, prof.w, prof.m_down)
    srv.observe(env, prof=measured, force=True)   # epoch 3: forced, measured
    assert srv.last_replanned and srv.last_plan_ok
    m = srv.metrics()
    assert m["replans"] == 3 and m["forced_replans"] == 2
    bad = dataclasses.replace(prof, fl=prof.fl[:-1])
    with pytest.raises(ProfileShapeError):
        srv.observe(env, prof=bad, force=True)
    assert srv.metrics() == m                     # nothing dispatched or counted
    srv.observe(env, hold=True)                   # held: the clock moves only
    assert srv.epoch == 5 and srv.replans == 3 and not srv.last_replanned


# -- the guard (tests/test_faults.py:281-313) ---------------------------------
def test_nan_profile_plan_rejected_and_held():
    """A NaN measured profile gives a NaN-utility plan; the guarded server
    rejects it through the packed word, holds the last good state and
    counts it."""
    env = _env(6, 2, 3)
    eng = _engine(**GUARD_CFG)
    srv = OnlineSplitServer(eng, replan_every=1, guard_plans=True)
    srv.observe(env)                              # cold plan, clean
    good = srv.state
    assert srv.last_plan_ok and srv.bad_plans == 0
    p = eng.prof
    srv.observe(env, prof=p.like(p.fl * float("nan"), p.w, p.m_down))
    assert srv.bad_plans == 1
    assert srv.last_plan_ok is False
    assert srv.state is good                      # held, not replaced
    assert bool(torch.isfinite(srv.state.plan.utility))


def test_unguarded_server_serves_the_nan():
    env = _env(6, 2, 3)
    eng = _engine(**GUARD_CFG)
    srv = OnlineSplitServer(eng, replan_every=1, guard_plans=False)
    srv.observe(env)
    p = eng.prof
    srv.observe(env, prof=p.like(p.fl * float("nan"), p.w, p.m_down))
    assert srv.bad_plans == 0                     # nothing trapped it
    assert not bool(torch.isfinite(srv.state.plan.utility))


def test_export_import_host_round_trip():
    srv = OnlineSplitServer(_engine(), replan_every=2)
    for seed in range(3):
        srv.observe(_env(seed=seed), force=seed == 1)
    back = OnlineSplitServer(_engine(), replan_every=2)
    back.import_host(srv.export_host(), srv._iters_acc.clone())
    assert back.export_host() == srv.export_host()
    assert back.metrics() == srv.metrics()
    assert back.programs is None                  # no model attached


# -- guard parity with the JAX package -----------------------------------------
def _corruptions(plan, n_sub):
    """The clean plan and one corruption a bit: NaN utility, p_up 10x its
    max, a negative compute allocation, an uplink subchannel = M."""
    return {
        "clean": {},
        "nan_utility": {"utility": np.float32(np.nan)},
        "p_up_10x_max": {"p_up": np.full_like(np.asarray(plan.p_up), 3.162)},
        "negative_r": {"r": -np.abs(np.asarray(plan.r))},
        "sub_up_is_M": {"sub_up": np.full_like(np.asarray(plan.sub_up), n_sub)},
    }


def test_plan_guards_match_the_reference(jx):
    jax = jx["jax"]
    jenv = jx["make_env"](jax.random.PRNGKey(0), 8, 2, 4)
    jeng = jx["Engine"](jx["profiles"].nin(), cfg=jx["GdConfig"](**GUARD_CFG))
    jplan = jeng.plan(jenv).plan
    kw = dict(n_sub=4, p_up_max=jenv.radio.p_up_max_w, p_dn_max=jenv.radio.p_dn_max_w,
              r_max=jenv.comp.r_max)
    fields = {f.name: np.asarray(getattr(jplan, f.name))
              for f in dataclasses.fields(jplan)}
    seen = set()
    for name, change in _corruptions(jplan, 4).items():
        bad = {**fields, **change}
        want_h = int(jx["guards"].plan_health(type(jplan)(**bad), **kw))
        want_w = int(jx["guards"].plan_word(type(jplan)(**bad), **kw))
        tplan = convert.split_plan_from_numpy(**bad, device="cpu")
        got_h = guards.plan_health(tplan, **kw)
        got_w = guards.plan_word(tplan, **kw)
        assert got_h.dtype == got_w.dtype == torch.int32
        assert (int(got_h), int(got_w)) == (want_h, want_w), name
        assert guards.split_plan_word(int(got_w)) == jx["guards"].split_plan_word(want_w)
        seen.add(want_h)
    # every plan bit was exercised once, and the clean plan is healthy
    assert seen == {0, 1, 2, 4, 8}
    assert guards.HEALTH_BITS == jx["guards"].HEALTH_BITS
    assert (guards.PLAN_MASK, guards.PLAN_WORD_SHIFT) == \
        (jx["guards"].PLAN_MASK, jx["guards"].PLAN_WORD_SHIFT)


def test_server_episode_counters_match_the_reference(jx):
    """One episode through both servers, epoch by epoch: five Scenario
    epochs (scheduled every 2, one forced), a measured profile, a NaN
    profile and a user-count change."""
    jax = jx["jax"]
    scfg = dict(n_users=8, n_aps=2, n_sub=4, fading_rho=0.97, speed_mps=0.5)
    jenvs = jx["Scenario"](jx["ScenarioConfig"](**scfg)).episode_list(
        jax.random.PRNGKey(3), 5)
    jprof = jx["profiles"].nin()
    jsrv = jx["Server"](jx["Engine"](jprof, cfg=jx["GdConfig"](**EPISODE_CFG)),
                        replan_every=2)
    tsrv = OnlineSplitServer(_engine(**EPISODE_CFG), replan_every=2)
    tprof = tsrv.engine.prof
    grown = jx["make_env"](jax.random.PRNGKey(9), 10, 2, 4)
    steps = [dict(env=e, force=(i == 3)) for i, e in enumerate(jenvs)]
    steps += [dict(env=jenvs[-1], force=True, prof=2.0),
              dict(env=jenvs[-1], force=True, prof=float("nan")),
              dict(env=grown, force=True)]
    for i, st in enumerate(steps):
        kw_j, kw_t = {"force": st["force"]}, {"force": st["force"]}
        if "prof" in st:
            kw_j["prof"] = jprof.like(jprof.fl * st["prof"], jprof.w, jprof.m_down)
            kw_t["prof"] = tprof.like(tprof.fl * st["prof"], tprof.w, tprof.m_down)
        jsrv.observe(st["env"], **kw_j)
        tsrv.observe(_port_env(st["env"]), **kw_t)
        for key in ("split_layer", "recuts", "replans", "forced_replans",
                    "cold_resets", "bad_plans", "epoch", "last_plan_ok"):
            assert getattr(tsrv, key) == getattr(jsrv, key), (i, key)
    assert (tsrv.bad_plans, tsrv.cold_resets) == (1, 1)


# -- re-cuts of a served model ---------------------------------------------------
def test_recut_programs_equal_make_split_serve_and_forward():
    """The reduced recurrentgemma-9b behind a server: after each re-cut the
    programs' logits equal make_split_serve(model, s)'s and the unsplit
    forward's to the bit. A measured profile with 1e3x the FLOPs makes
    compute dominate the utility, which moves s* off the unmeasured plan's
    (the edge's energy per FLOP at its smallest allocation is a third of
    the device's)."""
    cfg = configs.get("recurrentgemma-9b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    prof = profiles.from_arch_config(cfg, seq=32)
    srv = OnlineSplitServer(_engine(prof, **EPISODE_CFG), model=model)
    tokens = make_batch(0, 0, 1, 32, cfg.vocab_size, device="cpu")["tokens"]
    full, _, _ = model(tokens)
    env = _env(8, 2, 4, seed=2)
    seen = []
    for measured in (None, prof.like(prof.fl * 1e3, prof.w, prof.m_down)):
        progs = srv.observe(env, prof=measured, force=True)
        seen.append(srv.split_layer)
        assert progs.split_layer == srv.split_layer
        logits = progs.edge_fn(progs.device_fn(tokens))
        ref = make_split_serve(model, srv.split_layer)
        assert torch.equal(logits, ref.edge_fn(ref.device_fn(tokens)))
        assert torch.equal(logits, full)
    assert seen[0] != seen[1] and srv.recuts == 2, seen
    back = OnlineSplitServer(srv.engine, model=model)
    back.import_host(srv.export_host(), srv._iters_acc)
    assert back.programs.split_layer == srv.split_layer
    assert torch.equal(back.programs.edge_fn(back.programs.device_fn(tokens)), full)


def test_recut_programs_of_a_moe_model():
    """The same re-cuts over the reduced deepseek-moe-16b (a dense layer,
    then two MoE layers): the programs' logits equal the unsplit forward's
    to the bit at each planned split."""
    cfg = configs.get("deepseek-moe-16b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    prof = profiles.from_arch_config(cfg, seq=32)
    srv = OnlineSplitServer(_engine(prof, **EPISODE_CFG), model=model)
    tokens = make_batch(0, 0, 1, 32, cfg.vocab_size, device="cpu")["tokens"]
    full, _, _ = model(tokens)
    env = _env(8, 2, 4, seed=2)
    seen = []
    for measured in (None, prof.like(prof.fl * 1e3, prof.w, prof.m_down)):
        progs = srv.observe(env, prof=measured, force=True)
        seen.append(srv.split_layer)
        assert progs.split_layer == srv.split_layer
        assert torch.equal(progs.edge_fn(progs.device_fn(tokens)), full)
    assert seen[0] != seen[1] and srv.recuts == 2, seen
