"""The fleet path on the CPU: the NOMA kernels' plain twins with a member
dim, fleet autograd, and PlannerEngine.plan_many / replan_many, against the
JAX package (jax.vmap of its Pallas kernels in interpret mode, its own
vmapped plan_many / replan_many) and against the port's own single-member
paths.

Tolerances, and why:
- Batched twins against per-member twins: 1e-6 of each element's float32
  summation bound (the twin on absolute weights): the same terms, which a
  batched reduction may vectorize in another order.
- Twins and fleet gradients against the Pallas kernels: 1e-5 of that
  bound, as tests/test_torch_noma_kernels.py holds the single ones (float32
  sums in another order).
- plan_many / replan_many against the JAX engine (U=8, N=2, M=4, as
  tests/test_planning_engine.py uses): s*, per-split and total iterations,
  used_warm and subchannels exactly; utilities, powers and compute units to
  rtol 1e-5 (float32 optima reached by the same number of steps).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import make_env as jmake_env  # noqa: E402
from repro.core import profiles as jprof  # noqa: E402
from repro.core.types import GdConfig as JGdConfig  # noqa: E402
from repro.kernels import noma_rates as jnr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.planning import PlannerEngine as JEngine  # noqa: E402
from repro.planning import member as jmember  # noqa: E402
from repro.planning import stack_envs as jstack  # noqa: E402
from repro.scenarios import Scenario as JScenario  # noqa: E402
from repro.scenarios import ScenarioConfig as JScenarioConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import GdConfig, channel, li_gd  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core.types import make_weights  # noqa: E402
from repro_torch.kernels import noma_rates as nr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.planning import (  # noqa: E402
    PlannerEngine,
    WarmStateShapeError,
    member,
    stack_envs,
)
from repro_torch.scenarios import Scenario, ScenarioConfig  # noqa: E402

CFG = dict(optimizer="adam", max_iters=60)


def _close(got, want, scale=None, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want) if scale is None else np.asarray(scale)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = np.abs(got - want) > tol * scale
    assert not bad.any(), (f"{bad.sum()} elements off; worst "
                           f"{np.max(np.abs(got - want) / np.maximum(scale, 1e-38)):.3e}")


def _port_env(jenv):
    """A JAX env (one, or a stacked fleet) as the port's."""
    consts = jmember(jenv, 0) if jenv.g_up.ndim == 4 else jenv
    return convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), consts.radio, consts.comp,
                                  device="cpu")


def _fleet(b, u, n, m, seed, skew="natural"):
    """B make_env draws stacked; skew 'empty' moves member 0's last cell into
    cell 0 (one empty cell), 'giant' puts most users in one cell."""
    jenvs = [jmake_env(jax.random.PRNGKey(seed + i), n_users=u, n_aps=n, n_sub=m)
             for i in range(b)]
    if skew == "empty":
        ap = np.asarray(jenvs[0].ap).copy()
        ap[ap == n - 1] = 0
        jenvs[0] = dataclasses.replace(jenvs[0], ap=jnp.asarray(ap))
    elif skew == "giant":
        for i, e in enumerate(jenvs):
            ap = np.zeros(u, np.int32)
            ap[:: max(u // 3, 1)] = (n - 1 + i) % n
            jenvs[i] = dataclasses.replace(e, ap=jnp.asarray(ap))
    jenv = jstack(jenvs)
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(m), size=(b, u)).astype(np.float32)
    p = rng.uniform(1e-3, 0.3, size=(b, u)).astype(np.float32)
    cot = rng.standard_normal((2, b, u, m)).astype(np.float32)
    return jenv, _port_env(jenv), beta, p, cot


# (B, U, N, M, skew): ragged U/M against the Pallas blocks, N = 1, an empty
# cell, skewed cells, B = 1 and 3.
FLEETS = [(1, 9, 1, 12, "natural"), (3, 20, 3, 6, "natural"), (3, 13, 5, 7, "empty"),
          (3, 12, 4, 5, "giant"), (1, 16, 3, 8, "empty")]
FLEET_IDS = [f"B{c[0]}-{c[1]}x{c[2]}x{c[3]}-{c[4]}" for c in FLEETS]


def _operands(tenv, beta, p, cot, uplink):
    own, g_raw, ap = ops._inputs(tenv, uplink)
    tx = torch.tensor(beta * p[..., None])
    return own, g_raw, ap, tx, torch.tensor(cot[0]), torch.tensor(cot[1])


def _twin_calls(own, g_raw, ap, tx, c0, c1, n, uplink):
    """name -> (twin of the fleet, its summation-bound scale) for every
    kernel operand set of the forward and backward pass of one link."""
    w_in = tx * own if uplink else tx
    calls = {}
    for tag, w, desc in (("fwd", w_in, uplink), ("bwd", c0, not uplink)):
        calls[f"intra {tag}"] = (
            lambda w=w, desc=desc, f=nr.noma_cell_intra_dense_plain: f(own, own, w, ap, ap, n,
                                                                        desc),
            nr.noma_cell_intra_dense_plain(own, own, w.abs(), ap, ap, n, desc))
    if uplink:
        c_nm = nr.segment_table(c1, ap, n)
        calls["per_ap up"] = (lambda: nr.noma_per_ap_plain(ap, tx, g_raw, True),
                              nr.noma_per_ap_plain(ap, tx, g_raw, True))
        calls["contract up"] = (lambda: nr.noma_ap_contract_plain(ap, c_nm, g_raw, True),
                                nr.noma_ap_contract_plain(ap, c_nm.abs(), g_raw, True))
        calls["segment up"] = (lambda: nr.segment_table(c1, ap, n),
                               nr.segment_table(c1.abs(), ap, n))
    else:
        b_nm = nr.segment_table(tx, ap, n)
        calls["contract dn"] = (lambda: nr.noma_ap_contract_plain(ap, b_nm, g_raw, False),
                                nr.noma_ap_contract_plain(ap, b_nm, g_raw, False))
        calls["per_ap dn"] = (lambda: nr.noma_per_ap_plain(ap, c1, g_raw, False),
                              nr.noma_per_ap_plain(ap, c1.abs(), g_raw, False))
    return calls


@pytest.mark.parametrize("uplink", [True, False])
@pytest.mark.parametrize("case", FLEETS, ids=FLEET_IDS)
def test_batched_twins_match_per_member_twins(case, uplink):
    """Each batched twin (and segment_table) over the fleet against the same
    twin on each member alone, and the wrappers, which on the CPU take the
    twins, give the same for a fleet and a single member."""
    b, u, n, m, skew = case
    _, tenv, beta, p, cot = _fleet(b, u, n, m, seed=u + n, skew=skew)
    fleet_ops = _operands(tenv, beta, p, cot, uplink)
    fleet = {k: (f(), s) for k, (f, s) in _twin_calls(*fleet_ops, n, uplink).items()}
    for i in range(b):
        single = _twin_calls(*(x[i] for x in fleet_ops), n, uplink)
        for name, (f, _) in single.items():
            got, scale = fleet[name]
            _close(got[i], f(), scale[i], tol=1e-6)
    own, g_raw, ap, tx, c0, c1 = fleet_ops
    w_in = (tx * own) if uplink else tx
    whole = nr.noma_cell_intra_dense(own, own, w_in, ap, ap, n, uplink)
    table = nr.noma_per_ap(ap, tx if uplink else c1, g_raw, uplink)
    nm = nr.segment_table(c1 if uplink else tx, ap, n)
    contract = nr.noma_ap_contract(ap, nm, g_raw, uplink)
    assert whole.shape == (b, u, m) and table.shape == (b, n, m)
    assert contract.shape == (b, u, m)
    for i in range(b):
        assert torch.equal(whole[i], nr.noma_cell_intra_dense(own[i], own[i], w_in[i], ap[i],
                                                              ap[i], n, uplink))
        assert torch.equal(table[i], nr.noma_per_ap(ap[i], (tx if uplink else c1)[i],
                                                    g_raw[i], uplink))
        assert torch.equal(contract[i], nr.noma_ap_contract(ap[i], nm[i], g_raw[i], uplink))
    if n == 1:
        assert not contract.any() and not table.any()   # one AP: no other cell


@pytest.mark.parametrize("uplink", [True, False])
@pytest.mark.parametrize("case", FLEETS[1:4], ids=FLEET_IDS[1:4])
def test_batched_twins_match_vmapped_pallas(case, uplink):
    """The batched twins against jax.vmap of the three Pallas kernels (and
    _segment_table) in interpret mode, ragged against their blocks."""
    b, u, n, m, skew = case
    jenv, tenv, beta, p, cot = _fleet(b, u, n, m, seed=u + n, skew=skew)
    own, g_raw, ap, tx, c0, c1 = _operands(tenv, beta, p, cot, uplink)
    j = {k: jnp.asarray(v.numpy()) for k, v in dict(own=own, g=g_raw, ap=ap, tx=tx, c0=c0,
                                                     c1=c1).items()}
    w_in = tx * own if uplink else tx
    jw = j["tx"] * j["own"] if uplink else j["tx"]
    blocks = dict(block_m=8, interpret=True)
    for w_t, w_j, desc in ((w_in, jw, uplink), (c0, j["c0"], not uplink)):
        want = jax.vmap(lambda o, w, a, d=desc: jnr.noma_cell_intra_kernel(
            o, o, w, a, a, descending=d, block_r=4, block_s=8, **blocks))(j["own"], w_j, j["ap"])
        _close(nr.noma_cell_intra_dense_plain(own, own, w_t, ap, ap, n, desc), want,
               nr.noma_cell_intra_dense_plain(own, own, w_t.abs(), ap, ap, n, desc))
    kw = dict(block_w=4, block_n=2, **blocks)
    table_w, table_wj = (tx, j["tx"]) if uplink else (c1, j["c1"])
    want = jax.vmap(lambda a, w, g: jnr.noma_per_ap_kernel(a, w, g, uplink=uplink, **kw))(
        j["ap"], table_wj, j["g"])
    _close(nr.noma_per_ap_plain(ap, table_w, g_raw, uplink), want,
           nr.noma_per_ap_plain(ap, table_w.abs(), g_raw, uplink))
    nm_w, nm_wj = (c1, j["c1"]) if uplink else (tx, j["tx"])
    nm = nr.segment_table(nm_w, ap, n)
    jnm = jax.vmap(lambda v, a: jnr._segment_table(v, a, n))(nm_wj, j["ap"])
    _close(nm, jnm, nr.segment_table(nm_w.abs(), ap, n))
    want = jax.vmap(lambda a, t, g: jnr.noma_ap_contract_kernel(a, t, g, uplink=uplink, **kw))(
        j["ap"], jnm, j["g"])
    _close(nr.noma_ap_contract_plain(ap, nm, g_raw, uplink), want,
           nr.noma_ap_contract_plain(ap, nm.abs(), g_raw, uplink))


@pytest.mark.parametrize("link", ["up", "dn"])
def test_fleet_autograd_matches_vmapped_grad(link):
    """The fleet ops' gradient w.r.t. tx (B, U, M) against
    jax.vmap(jax.grad(...)) of the JAX ops in interpret mode, and the fleet
    forward against vmap of the forward."""
    jenv, tenv, beta, p, cot = _fleet(3, 13, 4, 7, seed=5)
    tx = beta * p[..., None]
    jfn = jops.noma_pairwise_up if link == "up" else jops.noma_pairwise_dn
    tfn = ops.noma_pairwise_up if link == "up" else ops.noma_pairwise_dn

    def jloss(env, x, c0, c1):
        i, o = jfn(env, x, interpret=True, block_u=4, block_v=4, block_m=8, block_n=2)
        return jnp.sum(i * c0) + jnp.sum(o * c1), (i, o)

    jg, (ji, jo) = jax.vmap(jax.grad(jloss, argnums=1, has_aux=True))(
        jenv, jnp.asarray(tx), jnp.asarray(cot[0]), jnp.asarray(cot[1]))
    xt = torch.tensor(tx, requires_grad=True)
    ti, to = tfn(tenv, xt)
    c0, c1 = torch.tensor(cot[0]), torch.tensor(cot[1])
    (tg,) = torch.autograd.grad((ti * c0).sum() + (to * c1).sum(), [xt], retain_graph=True)
    # Both outputs are linear in tx with coefficients >= 0: the gradient for
    # |cot| sums the magnitudes of the gradient's terms.
    (tg_abs,) = torch.autograd.grad((ti * c0.abs()).sum() + (to * c1.abs()).sum(), [xt])
    _close(ti.detach(), ji)
    _close(to.detach(), jo)
    _close(tg, jg, tg_abs)


def test_fleet_utility_gradient_matches_vmapped_grad():
    """The fleet utility (B,) and its gradient in every normalized variable
    through the kernel backend, against jax.vmap(jax.value_and_grad(...))
    of the JAX utility on the einsum backend, at the cold start of split 3."""
    from repro.core import li_gd as jli
    from repro.core.types import make_weights as jmake_weights
    from repro.core.utility import utility as jutility
    from repro_torch.core.utility import utility
    jenv, tenv, *_ = _fleet(3, 10, 3, 5, seed=8)
    jw, tw = jmake_weights(10), make_weights(10, device="cpu")

    def jgamma(env, norm):
        return jutility(env, jprof.nin(), 3, jli.to_physical(norm, env), jw, backend="einsum")

    jnorm = jax.vmap(jli.cold_init)(jenv)
    jval, jgrad = jax.vmap(jax.value_and_grad(jgamma, argnums=1))(jenv, jnorm)
    x = {k: v.clone().requires_grad_(True) for k, v in li_gd.cold_init(tenv).items()}
    gamma = utility(tenv, tprof.nin(), 3, li_gd.to_physical(x, tenv), tw, backend="kernel")
    grads = torch.autograd.grad(gamma.sum(), [x[k] for k in li_gd.KEYS])
    assert gamma.shape == (3,)
    _close(gamma.detach(), jval)
    for k, g in zip(li_gd.KEYS, grads):
        want = np.asarray(jgrad[k])
        # each (user) row to its largest magnitude: its terms have both signs
        _close(g, want, np.max(np.abs(want), axis=-1, keepdims=True))


# -- the engine ------------------------------------------------------------
def _assert_fleet_matches(tstate, jstate):
    tp, jp = tstate.plan, jstate.plan
    for field in ("s", "sub_up", "sub_dn", "iters"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)))
    np.testing.assert_array_equal(tstate.total_iters.numpy(), np.asarray(jstate.total_iters))
    np.testing.assert_array_equal(tstate.opt_steps.numpy(), np.asarray(jstate.opt_steps))
    for field in ("p_up", "p_dn", "r", "utility", "per_layer_utility"):
        np.testing.assert_allclose(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)),
                                   rtol=1e-5)


def _used_warm(state):
    return (np.asarray(state.opt_steps) > np.asarray(state.plan.iters)).astype(int)


def _engines(cfg=CFG, **kw):
    return (JEngine(jprof.nin(), cfg=JGdConfig(**cfg), sinr_backend="einsum", **kw),
            PlannerEngine(tprof.nin(), cfg=GdConfig(**cfg), sinr_backend="kernel",
                          device="cpu", **kw))


def test_plan_many_and_replan_many_match_reference_on_make_env():
    """Stacked make_env fleets: plan_many, then replan_many on a correlated
    next epoch (gains x exp(0.05 N(0,1))), against the JAX engine."""
    je, te = _engines()
    jenv, tenv, *_ = _fleet(3, 8, 2, 4, seed=0)
    rng = np.random.default_rng(0)
    g_up = (np.asarray(jenv.g_up) * np.exp(0.05 * rng.standard_normal(jenv.g_up.shape))
            ).astype(np.float32)
    g_dn = (np.asarray(jenv.g_dn) * np.exp(0.05 * rng.standard_normal(jenv.g_dn.shape))
            ).astype(np.float32)
    jenv2 = dataclasses.replace(jenv, g_up=jnp.asarray(g_up), g_dn=jnp.asarray(g_dn))
    js, ts = je.plan_many(jenv), te.plan_many(tenv)
    _assert_fleet_matches(ts, js)
    assert ts.warm_rho is None and ts.plan.s.shape == (3,)
    js2, ts2 = je.replan_many(js, jenv2), te.replan_many(ts, _port_env(jenv2))
    _assert_fleet_matches(ts2, js2)
    np.testing.assert_allclose(ts2.warm_rho.numpy(), np.asarray(js2.warm_rho), rtol=1e-5)
    assert _used_warm(ts2).tolist() == _used_warm(js2).tolist()
    assert _used_warm(ts2).any()


def _port_fleet_state(js):
    """A JAX fleet PlanState carried across with convert."""
    return convert.fleet_plan_state_from_numpy(
        {k: np.asarray(v) for k, v in js.norms.items()},
        moms=tuple({k: np.asarray(v) for k, v in mm.items()} for mm in js.moms),
        opt_steps=np.asarray(js.opt_steps), gains=np.asarray(js.gains), device="cpu")


def _scaled(jenv, f):
    return dataclasses.replace(jenv, g_up=jenv.g_up * f, g_dn=jenv.g_dn * f)


def test_plan_many_and_replan_many_match_reference_on_scenario_fleets():
    """Scenario.env_many fleets of the JAX package (fading rho 0.97, walking
    users, no churn), carried across: plan_many, then two epochs of
    replan_many, each from the reference's previous state (so one epoch's
    outcome does not feed the next).

    The reference's own stopping step can hang on float32 rounding: on
    epoch 2 of this fleet, member 0's split 5 stops after 8 steps, and
    after 60 when the reference's gains are scaled by 1 - 1e-7 (ROADMAP
    section 3). Each member is held exactly to the reference's run where the
    reference's counts do not move under that scaling (1 +- 1e-7), and to
    the one of those three runs whose counts it matches where they do."""
    je, te = _engines()
    scfg = JScenarioConfig(n_users=8, n_aps=2, n_sub=4, fading_rho=0.97, speed_mps=0.5,
                           arrival_rate_hz=0.0)
    sc = JScenario(scfg)
    states = sc.init_many(jax.random.split(jax.random.PRNGKey(4), 3))
    js, moved = None, 0
    for t in range(3):
        jenvs = sc.env_many(states)
        ts = te.replan_many(None if js is None else _port_fleet_state(js), _port_env(jenvs))
        runs = [je.replan_many(js, _scaled(jenvs, f)) for f in (1.0, 1 + 1e-7, 1 - 1e-7)]
        for i in range(3):
            one = [jmember(r, i) for r in runs]
            iters = [np.asarray(r.plan.iters).tolist() for r in one]
            got = member(ts, i)
            if iters.count(iters[0]) < len(iters):
                moved += 1
                assert got.plan.iters.tolist() in iters, (t, i, iters)
                want = one[iters.index(got.plan.iters.tolist())]
            else:
                want = one[0]
            _assert_fleet_matches(got, want)
            assert _used_warm(got).tolist() == _used_warm(want).tolist()
            if t:
                np.testing.assert_allclose(float(got.warm_rho), float(want.warm_rho),
                                           rtol=1e-5)
        js = runs[0]
        states = sc.step_many(jax.random.split(jax.random.PRNGKey(100 + t), 3), states)
    assert moved <= 1      # the one knife edge the docstring names


def test_replan_many_matches_sequential_replans():
    """The port's fleet against its own sequential replan of each member,
    epoch by epoch, on its own Scenario fleet (mirrors the JAX package's
    test_replan_many_matches_sequential): the same s*, iterations per split
    and in total, warm choices and subchannels, utilities to 1e-5."""
    cfg = dict(optimizer="adam", step_size=1e-2, eps=1e-4, max_iters=100)
    fleet_eng = PlannerEngine(tprof.nin(), cfg=GdConfig(**cfg), sinr_backend="kernel",
                              device="cpu")
    seq_eng = PlannerEngine(tprof.nin(), cfg=GdConfig(**cfg), sinr_backend="kernel",
                            device="cpu")
    sc = Scenario(ScenarioConfig(n_users=8, n_aps=2, n_sub=4, fading_rho=0.97,
                                 speed_mps=0.0), device="cpu")
    seeds = [11, 12, 13, 14]
    states = sc.init_many(seeds)
    batched, seq = None, [None] * len(seeds)
    for _ in range(3):
        envs = sc.env_many(states)
        batched = fleet_eng.replan_many(batched, envs)
        for i in range(len(seeds)):
            seq[i] = seq_eng.replan(seq[i], member(envs, i))
            one = member(batched, i)
            assert int(one.plan.s) == int(seq[i].plan.s)
            assert one.plan.iters.tolist() == seq[i].plan.iters.tolist()
            assert int(one.total_iters) == int(seq[i].total_iters)
            assert one.opt_steps.tolist() == seq[i].opt_steps.tolist()
            assert torch.equal(one.plan.sub_up, seq[i].plan.sub_up)
            assert torch.equal(one.plan.sub_dn, seq[i].plan.sub_dn)
            np.testing.assert_allclose(float(one.plan.utility), float(seq[i].plan.utility),
                                       rtol=1e-5)
        states = sc.step_many(seeds, states)


def test_shape_guards_for_fleet_and_single_states():
    """A fleet state handed to replan() and a single state handed to
    replan_many() are told what to use instead (mirrors the JAX package's
    test_shape_guard_batched_vs_single_states), with its messages."""
    from repro_torch.core import make_env
    eng = PlannerEngine(tprof.nin(), cfg=GdConfig(optimizer="adam", max_iters=5),
                        device="cpu")
    single_env = make_env(8, 2, 4, seed=9, device="cpu")
    envs = [make_env(8, 2, 4, seed=s, device="cpu") for s in range(2)]
    fleet_state = eng.plan_many(envs)
    single_state = eng.plan(single_env)
    assert fleet_state.plan.s.shape == (2,) and fleet_state.total_iters.shape == (2,)
    with pytest.raises(WarmStateShapeError, match="replan_many"):
        eng.replan(fleet_state, single_env)
    with pytest.raises(WarmStateShapeError, match="plan_many|replan\\(\\)"):
        eng.replan_many(single_state, envs)
    envs3 = [make_env(8, 2, 4, seed=s, device="cpu") for s in (5, 6, 7)]
    with pytest.raises(WarmStateShapeError, match="fleet of 2"):
        eng.replan_many(fleet_state, envs3)
    with pytest.raises(WarmStateShapeError, match="users"):
        eng.replan(single_state, make_env(6, 2, 4, seed=3, device="cpu"))
    with pytest.raises(WarmStateShapeError, match="use replan\\(\\)"):
        eng.replan_many(fleet_state, single_env)
    with pytest.raises(ValueError, match="use plan\\(\\)"):
        eng.plan_many(single_env)
    with pytest.raises(ValueError, match="plan_many"):
        eng.plan(stack_envs(envs))
    with pytest.raises(ValueError, match="at least one"):
        eng.replan_many(fleet_state, [])
    bad = [make_env(6, 2, 4, seed=s, device="cpu") for s in range(2)]
    with pytest.raises(WarmStateShapeError):
        eng.replan_many(fleet_state, bad)
    cold = eng.replan_many(None, envs)             # falls back to plan_many
    assert cold.warm_rho is None and cold.plan.s.shape == (2,)
    warm = eng.replan_many(fleet_state, stack_envs(envs))
    assert warm.warm_rho.shape == (2,)
    with pytest.raises(ValueError, match="fleet"):
        ops.noma_pairwise_up(stack_envs(envs), torch.ones(2, 8, 4),
                             layout=object())


def test_reference_fleet_state_warm_starts_the_port_at_fixed_steps():
    """A JAX plan_many state, carried across with
    convert.fleet_plan_state_from_numpy, warm-starts the port's
    replan_many to the reference's own replan_many at U=100, N=8, M=20.
    At this size a split's stopping step hangs on float32 summation order
    (ROADMAP section 3), so every split runs a fixed 15 steps (eps=0) and
    the warm path itself is held: the same rho estimate and warm-or-carry
    choice per member and split, s*, subchannels and plan."""
    cfg = dict(optimizer="adam", max_iters=15, eps=0.0)
    je, te = _engines(cfg)
    jenv, _, *_ = _fleet(2, 100, 8, 20, seed=3)
    rng = np.random.default_rng(3)
    g_up = (np.asarray(jenv.g_up) * np.exp(0.05 * rng.standard_normal(jenv.g_up.shape))
            ).astype(np.float32)
    g_dn = (np.asarray(jenv.g_dn) * np.exp(0.05 * rng.standard_normal(jenv.g_dn.shape))
            ).astype(np.float32)
    jenv2 = dataclasses.replace(jenv, g_up=jnp.asarray(g_up), g_dn=jnp.asarray(g_dn))
    js = je.plan_many(jenv)
    prev = _port_fleet_state(js)
    js2, ts2 = je.replan_many(js, jenv2), te.replan_many(prev, _port_env(jenv2))
    tp, jp = ts2.plan, js2.plan
    for field in ("s", "sub_up", "sub_dn", "iters"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)))
    np.testing.assert_array_equal(ts2.opt_steps.numpy(), np.asarray(js2.opt_steps))
    np.testing.assert_allclose(ts2.warm_rho.numpy(), np.asarray(js2.warm_rho), rtol=1e-5)
    for field in ("p_up", "p_dn", "r"):
        np.testing.assert_allclose(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)),
                                   rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tp.utility.numpy(), np.asarray(jp.utility), rtol=1e-4)
    used = _used_warm(ts2)
    assert 0 < used.sum() < used.size                  # both choices made
    with pytest.raises(ValueError, match="fleet"):
        convert.fleet_plan_state_from_numpy({k: v[0] for k, v in prev.norms.items()})


def test_single_env_is_a_fleet_of_one():
    """plan on one env equals plan_many on the fleet of that one env, and
    the fleet of one's kernel calls see a member dim of 1."""
    from repro_torch.core import make_env
    eng = PlannerEngine(tprof.nin(), cfg=GdConfig(**CFG), sinr_backend="kernel", device="cpu")
    env = make_env(9, 3, 5, seed=2, device="cpu")
    one, fleet = eng.plan(env), eng.plan_many([env])
    assert one.plan.iters.shape == (tprof.nin().n_layers + 1,)
    for field in ("s", "sub_up", "sub_dn", "iters", "p_up", "p_dn", "r", "utility"):
        assert torch.equal(getattr(fleet.plan, field)[0], getattr(one.plan, field)), field
    assert channel.uplink_rates(stack_envs([env]), torch.full((1, 9, 5), 0.2),
                                torch.full((1, 9), 0.1), backend="kernel").shape == (1, 9, 5)
