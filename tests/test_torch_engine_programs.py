"""The engine's compiled programs (planning.programs) on the CPU, beside the
JAX engine where both can run: the cache (reuse, keys, backend and cfg
keys, the warm_rho_min retune), compile_log in the serving loops (a
measured profile, steady-state epochs, a fault-rate swap, a restored loop),
program / program_args against the entry points, outputs that no later
call moves, and the sync-free rewrite of the projection floor and the rate
floor against the formulas it replaced.

On the CPU a program runs its GD steps eagerly on its static buffers, so
these tests reach everything but the capture and the replay;
tests/test_torch_graphs_cuda.py holds the graphs on the card.

Both engines plan at U=8, N=2, M=4 (U=6, N=2, M=3 for a shape change) with
Adam; where the port's plan is held to the reference's, it is to the bound
of tests/test_torch_engine.py (s and the iteration counts exactly, the
utility to rtol 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_online_loop import CHAOS, LOADED, port_loop  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import GdConfig, channel, li_gd, make_env, profiles  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402
from repro_torch.faults import FaultConfig  # noqa: E402
from repro_torch.planning import (  # noqa: E402
    PlannerEngine,
    compile_log,
    stack_envs,
)
from repro_torch.runtime import OnlineSplitServer  # noqa: E402
from repro_torch.state import SnapshotConfig, SnapshotStore, load_snapshot  # noqa: E402

# tests/test_planning_engine.py's ADAM_CFG with max_iters cut to 60.
ADAM = dict(step_size=1e-2, eps=1e-4, max_iters=60, optimizer="adam")
KINDS = ("plan", "plan_many", "replan", "replan_many")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from repro.core import GdConfig as JGdConfig
    from repro.core import make_env as jmake_env
    from repro.core import profiles as jprofiles
    from repro.planning import PlannerEngine as JEngine
    from repro.planning import compile_log as jcompile_log
    from repro.planning import stack_envs as jstack_envs
    return dict(jax=jax, GdConfig=JGdConfig, make_env=jmake_env, profiles=jprofiles,
                Engine=JEngine, compile_log=jcompile_log, stack_envs=jstack_envs)


def _envs(jx, u, n, m, seed):
    """A JAX env and the port's copy of it."""
    jenv = jx["make_env"](jx["jax"].random.PRNGKey(seed), u, n, m)
    tenv = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp, device="cpu")
    return jenv, tenv


def _engines(jx, **kw):
    cfg = kw.pop("cfg", ADAM)
    return (PlannerEngine(profiles.nin(), cfg=GdConfig(**cfg), device="cpu", **kw),
            jx["Engine"](jx["profiles"].nin(), cfg=jx["GdConfig"](**cfg), **kw))


def _same_plan(tp, jp):
    assert np.asarray(tp.s).tolist() == np.asarray(jp.s).tolist()
    assert np.asarray(tp.iters).tolist() == np.asarray(jp.iters).tolist()
    np.testing.assert_allclose(np.asarray(tp.utility), np.asarray(jp.utility), rtol=1e-4)


def _equal_trees(a, b) -> None:
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    assert str(ta) == str(tb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _leaves(tree) -> list:
    return [x.clone() for x in tree_flatten(tree)[0]]


# -- the cache ------------------------------------------------------------------
def test_cache_reuse_matches_reference(jx):
    """Same shape, one program; a new shape, a second (the reference's
    test_engine_cache_reuse), in both engines; compile_log records each
    build once."""
    teng, jeng = _engines(jx)
    with compile_log() as log, jx["compile_log"]() as jlog:
        for seed in (0, 1):
            jenv, tenv = _envs(jx, 8, 2, 4, seed)
            _same_plan(teng.plan(tenv).plan, jeng.plan(jenv).plan)
        assert teng.cache_size() == jeng.cache_size() == 1
        jenv, tenv = _envs(jx, 6, 2, 3, 2)
        _same_plan(teng.plan(tenv).plan, jeng.plan(jenv).plan)
        assert teng.cache_size() == jeng.cache_size() == 2
    assert log == jlog == ["plan", "plan"]


def test_cache_keys_match_reference(jx):
    """Each kind's key: the kind and the env shape as the reference's, then
    the port's GdConfig, method, rounding and the two warm constants."""
    teng, jeng = _engines(jx)
    pairs = [_envs(jx, 8, 2, 4, s) for s in (0, 1, 2, 3)]
    tfleet = stack_envs([t for _, t in pairs[:2]])
    jfleet = jx["stack_envs"]([j for j, _ in pairs[:2]])
    tfleet2 = stack_envs([t for _, t in pairs[2:]])
    jfleet2 = jx["stack_envs"]([j for j, _ in pairs[2:]])
    tp, jp = teng.plan(pairs[0][1]), jeng.plan(pairs[0][0])
    teng.replan(tp, pairs[1][1])
    jeng.replan(jp, pairs[1][0])
    tf, jf = teng.plan_many(tfleet), jeng.plan_many(jfleet)
    teng.replan_many(tf, tfleet2)
    jeng.replan_many(jf, jfleet2)
    tkeys, jkeys = teng.cache_keys(), jeng.cache_keys()
    assert [k[:2] for k in tkeys] == [k[:2] for k in jkeys]
    assert sorted(k[0] for k in tkeys) == sorted(KINDS)
    for key in tkeys:
        assert key[2:] == (teng.cfg, "li_gd", "best", 0.5, 0.1)


def test_cfg_and_backend_key(jx):
    """The backend is folded into GdConfig, hence into the key: switching
    channel's global builds nothing and changes nothing; assigning
    engine.cfg mints a key (as the reference's test_engine_backend_cache_keys),
    beside the reference doing the same with a cfg change."""
    teng, jeng = _engines(jx)
    jenv, tenv = _envs(jx, 8, 2, 4, 0)
    ref = teng.plan(tenv)
    jeng.plan(jenv)
    prev = channel.set_sinr_backend("kernel")
    try:
        with compile_log() as log:
            again = teng.plan(tenv)
    finally:
        channel.set_sinr_backend(prev)
    assert log == [] and teng.cache_size() == 1
    _equal_trees(again, ref)
    teng.cfg = dataclasses.replace(teng.cfg, sinr_backend="kernel")
    with compile_log() as log:
        kern = teng.plan(tenv)
    assert log == ["plan"] and teng.cache_size() == 2
    assert teng.cache_keys()[1][2].sinr_backend == "kernel"
    _same_plan(kern.plan, ref.plan)
    jeng.cfg = dataclasses.replace(jeng.cfg, max_iters=59)
    teng.cfg = dataclasses.replace(teng.cfg, max_iters=59)
    teng.plan(tenv)
    jeng.plan(jenv)
    assert teng.cache_size() == 3 and jeng.cache_size() == 2


def test_gate_retune_mints_a_key_as_the_reference(jx):
    """The reference's test_gate_retune_recompiles in both engines: the
    retuned gate is a new program, gates the stale start off (the exact cold
    chain), and gives the reference's retuned result."""
    teng, jeng = _engines(jx, warm_rho_min=0.0)
    jenv, tenv = _envs(jx, 8, 2, 4, 0)
    jenv2, tenv2 = _envs(jx, 8, 2, 4, 42)        # an uncorrelated draw
    tfirst, jfirst = teng.plan(tenv), jeng.plan(jenv)
    _same_plan(teng.replan(tfirst, tenv2).plan, jeng.replan(jfirst, jenv2).plan)
    n = teng.cache_size()
    assert n == jeng.cache_size()
    teng.warm_rho_min = jeng.warm_rho_min = 1.0
    with compile_log() as log, jx["compile_log"]() as jlog:
        tgated, jgated = teng.replan(tfirst, tenv2), jeng.replan(jfirst, jenv2)
    assert log == jlog == ["replan"]
    assert teng.cache_size() == jeng.cache_size() == n + 1
    _same_plan(tgated.plan, jgated.plan)
    cold = teng.plan(tenv2)
    assert int(tgated.total_iters) == int(cold.total_iters)
    assert float(tgated.plan.utility) == pytest.approx(float(cold.plan.utility), abs=1e-6)


def test_constants_change_builds_again_in_the_same_program():
    """The port's one difference from the reference's keys: the radio and
    compute constants enter a capture as constants, so new constants build
    the program's graphs anew (logged) under the same key; the reference
    passes them as operands."""
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(**ADAM), device="cpu")
    env = make_env(8, 2, 4, seed=0, device="cpu")
    other = dataclasses.replace(env, radio=dataclasses.replace(env.radio, beta_min=2e-3))
    with compile_log() as outer:
        eng.plan(env)
        with compile_log() as inner:
            eng.plan(other)
            eng.plan(other)
        eng.plan(env)
    assert inner == ["plan"] and outer == ["plan", "plan"]
    assert eng.cache_size() == 1


# -- program / program_args --------------------------------------------------------
@pytest.mark.parametrize("kind", KINDS)
def test_program_equals_the_entry_point(kind):
    """program(kind, env)(*program_args(kind, env, prev=...)) returns what
    the entry point returns, leaf for leaf, and builds nothing new."""
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(**ADAM), device="cpu")
    envs = [make_env(8, 2, 4, seed=s, device="cpu") for s in range(4)]
    many = kind.endswith("many")
    env0 = stack_envs(envs[:2]) if many else envs[0]
    env1 = stack_envs(envs[2:]) if many else envs[1]
    prev = eng.plan_many(env0) if many else eng.plan(env0)
    entry = getattr(eng, kind)
    want = entry(env0) if kind.startswith("plan") else entry(prev, env1)
    env = env0 if kind.startswith("plan") else env1
    n = eng.cache_size()
    with compile_log() as log:
        got = eng.program(kind, env)(*eng.program_args(kind, env, prev=prev))
    assert log == [] and eng.cache_size() == n
    _equal_trees(got, want)


@pytest.mark.parametrize("kind", ("replan", "replan_many"))
def test_program_args_need_prev_for_a_replan(jx, kind):
    teng, jeng = _engines(jx)
    jenv, tenv = _envs(jx, 8, 2, 4, 0)
    if kind == "replan_many":
        tenv, jenv = stack_envs([tenv, tenv]), jx["stack_envs"]([jenv, jenv])
    for eng, env in ((teng, tenv), (jeng, jenv)):
        with pytest.raises(ValueError, match="prev"):
            eng.program_args(kind, env)
    assert len(teng.program_args(kind.replace("replan", "plan"), tenv)) == 3


def test_unknown_kind_raises():
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(**ADAM), device="cpu")
    with pytest.raises(KeyError):
        eng.program("plan_many_sharded", make_env(8, 2, 4, seed=0, device="cpu"))


@pytest.mark.parametrize("many", (False, True))
def test_outputs_never_alias_the_programs_buffers(many):
    """A held state does not move when later calls run (replan reads prev
    while it overwrites the program's buffers), and no returned tensor
    shares storage with a program's static buffers."""
    eng = PlannerEngine(profiles.nin(), cfg=GdConfig(**ADAM), device="cpu")
    envs = [make_env(8, 2, 4, seed=s, device="cpu") for s in range(6)]
    pick = (lambda i: stack_envs(envs[2 * i:2 * i + 2])) if many else (lambda i: envs[i])
    plan_fn, replan_fn = ((eng.plan_many, eng.replan_many) if many
                          else (eng.plan, eng.replan))
    first = plan_fn(pick(0))
    held = _leaves(first)
    second = replan_fn(first, pick(1))
    held2 = _leaves(second)
    third = replan_fn(second, pick(2))
    plan_fn(pick(2))
    for got, want in ((first, held), (second, held2)):
        for x, y in zip(tree_flatten(got)[0], want):
            assert torch.equal(x, y)
    static = {b.untyped_storage().data_ptr()
              for prog in eng._cache.values()
              for part in (prog._operands, prog._state) if part is not None
              for b in part[1]}
    for prog in eng._cache.values():
        assert prog._loop is None        # static loop results only on the card
    for st in (first, second, third):
        for x in tree_flatten(st)[0]:
            assert x.untyped_storage().data_ptr() not in static


# -- compile_log in the serving loops ------------------------------------------------
def test_server_measured_profile_logs_nothing():
    """A measured profile of the static one's shape goes through the same
    program (the reference's test_online_split_server_forced_and_measured_replans)."""
    prof = profiles.nin()
    srv = OnlineSplitServer(PlannerEngine(prof, cfg=GdConfig(**ADAM), device="cpu"),
                            replan_every=4)
    env = make_env(8, 2, 4, seed=0, device="cpu")
    srv.observe(env)                              # epoch 0: scheduled (plan)
    srv.observe(env)
    srv.observe(env, force=True)                  # epoch 2: forced (replan builds)
    measured = prof.like(prof.fl * 2.0, prof.w, prof.m_down)
    with compile_log() as log:
        srv.observe(env, prof=measured, force=True)
    assert log == [] and srv.last_replanned
    assert srv.engine.cache_size() == 2


def test_steady_state_loop_logs_nothing():
    """After warm-up a feedback episode (measured-profile replans
    included) builds nothing (the reference's test_steady_state_compiles_once)."""
    loop = port_loop(LOADED)
    loop.reset(0)
    for _ in range(12):
        loop.step_epoch()
    n = loop.engine.cache_size()
    with compile_log() as log:
        for _ in range(12):
            loop.step_epoch()
    assert log == [] and loop.engine.cache_size() == n


def test_fault_rate_swap_logs_nothing():
    """The reference's test_rate_swap_traces_nothing on the hardened loop."""
    loop = port_loop(CHAOS)
    loop.reset(0)
    for _ in range(10):
        loop.step_epoch()
    with compile_log() as log:
        loop.set_fault_rates(FaultConfig(link_outage_rate=0.5, telemetry_drop_rate=0.3))
        for _ in range(6):
            loop.step_epoch()
    assert log == []


def test_restored_loop_logs_nothing_and_keeps_cache_size(tmp_path):
    """A snapshot restored into a fresh loop (new engine), warmed up, then
    CADENCE epochs and a serving-state capture under compile_log: nothing
    builds, and the engine holds as many programs as the original's (the
    reference's tests/test_state.py `resumed`)."""
    cadence, total = 6, 18
    store = SnapshotStore(str(tmp_path), SnapshotConfig(every=cadence, keep_n=3,
                                                        asynchronous=False))
    loop = port_loop(CHAOS)
    loop.reset(3)
    for _ in range(2 * cadence):
        loop.step_epoch()
        store.maybe_save(loop)
    for _ in range(total - 2 * cadence):
        loop.step_epoch()
    fresh = port_loop(CHAOS)
    fresh.reset(3)
    load_snapshot(str(tmp_path), fresh, 2 * cadence)
    for _ in range(total - 2 * cadence):
        fresh.step_epoch()
    with compile_log() as log:
        for _ in range(cadence):
            fresh.step_epoch()
        fresh.serving_state()
    assert log == []
    assert fresh.engine.cache_size() == loop.engine.cache_size()


# -- the sync-free step: the rewritten floors against the formulas they replace -----
def _old_project_simplex_floor(y, floor):
    m = y.shape[-1]
    f = torch.minimum(torch.tensor(floor, dtype=y.dtype, device=y.device),
                      torch.tensor(1.0 / m, dtype=y.dtype, device=y.device))
    z = li_gd.project_simplex(y - f, total=1.0 - m * f)
    return z + f


@pytest.mark.parametrize("shape", [(9, 6), (3, 4), (2, 5, 7), (4, 1), (3, 250)])
@pytest.mark.parametrize("floor", [0.0, 1e-3, 0.05, 0.2499, 0.3, 1.0])
def test_projection_floor_bit_equal_to_the_old_formula(shape, floor):
    """Floors above 1/m included (0.3 and 1.0 against m=4, 6 and 7)."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    y = (rng.standard_normal(shape) * 0.7).astype(np.float32)
    y.reshape(-1, shape[-1])[0] = 1.0 / shape[-1]      # on the simplex, with ties
    y.reshape(-1, shape[-1])[-1] = -2.0                # all below the floor
    yt = torch.tensor(y)
    got = li_gd.project_simplex_floor(yt, floor)
    want = _old_project_simplex_floor(yt, floor)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("u,n,m", [(8, 2, 4), (6, 2, 3), (12, 3, 5)])
def test_rate_floor_bit_equal_to_the_old_formula(u, n, m):
    """user_rates and oma_rates, values and gradients, against the floor
    built by new_tensor; the first user's powers at the minimum and its
    shares at zero put its rate at the floor (a tie for the maximum)."""
    env = make_env(u, n, m, seed=u, device="cpu")
    rng = np.random.default_rng(u)
    beta = torch.tensor(rng.dirichlet(np.ones(m), size=u).astype(np.float32))
    beta[0] = 0.0
    p_up = torch.tensor(rng.uniform(1e-3, 0.3, u).astype(np.float32))
    p_dn = torch.tensor(rng.uniform(0.1, 10.0, u).astype(np.float32))
    assert torch.equal(channel._rate_floor(p_up), p_up.new_tensor(1e-9))

    def old_user_rates(b, q_up, q_dn):
        r_up = channel.uplink_rates(env, b, q_up, backend="einsum").sum(-1)
        r_dn = channel.downlink_rates(env, b, q_dn, backend="einsum").sum(-1)
        floor = r_up.new_tensor(1e-9)
        return torch.maximum(r_up, floor), torch.maximum(r_dn, floor)

    outs = []
    for fn in (lambda b, q, r: channel.user_rates(env, b, b, q, r, backend="einsum"),
               old_user_rates):
        x = [t.clone().requires_grad_(True) for t in (beta, p_up, p_dn)]
        r_up, r_dn = fn(*x)
        grads = torch.autograd.grad((r_up + 2.0 * r_dn).sum(), x)
        outs.append([r_up.detach(), r_dn.detach(), *grads])
    assert float(outs[0][0][0]) == pytest.approx(1e-9)
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    oma = channel.oma_rates(env, p_up, p_dn)
    own_up, own_dn = env.own_gain_up(), env.own_gain_dn()
    counts = torch.sum(env.same_cell(), dim=-1).to(own_up.dtype)
    r_up = (env.radio.bandwidth_up_hz / counts * torch.log1p(
        p_up * torch.amax(own_up, -1) / (env.noise_up * m)) / channel.LOG2)
    r_dn = (env.radio.bandwidth_dn_hz / counts * torch.log1p(
        p_dn * torch.amax(own_dn, -1) / (env.noise_dn * m)) / channel.LOG2)
    floor = r_up.new_tensor(1e-9)
    assert torch.equal(oma[0], torch.maximum(r_up, floor))
    assert torch.equal(oma[1], torch.maximum(r_dn, floor))
