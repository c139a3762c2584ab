"""The port's Li-GD solver (core/li_gd.py) against the JAX package on the
CPU: projections, gd_solve iteration counts and optima, the gd_loop modes,
the warm-start probe's choices, rounding and plan assembly.

Iteration counts and discrete choices must be equal; continuous values
agree to rtol 1e-5 (float32 arithmetic in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import li_gd as jli  # noqa: E402
from repro.core import make_env as jmake_env  # noqa: E402
from repro.core import profiles as jprof  # noqa: E402
from repro.core.types import GdConfig as JGdConfig  # noqa: E402
from repro.core.types import make_weights as jmake_weights  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import GdConfig, li_gd, make_weights  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402

KEYS = li_gd.KEYS


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _envs(u, n, m, seed):
    jenv = jmake_env(jax.random.PRNGKey(seed), n_users=u, n_aps=n, n_sub=m)
    tenv = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp,
                                  device="cpu")
    return jenv, tenv


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


@pytest.mark.parametrize("floor", [0.0, 1e-3, 0.05, 0.3])
def test_project_simplex_and_floor_match_reference(floor):
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((9, 6)) * 0.7).astype(np.float32)
    y[0] = 1.0 / 6              # a row already on the simplex, with ties
    y[1] = -2.0                 # all below the floor
    _close(li_gd.project_simplex(torch.tensor(y)), jli.project_simplex(jnp.asarray(y)),
           1e-6)
    got = li_gd.project_simplex_floor(torch.tensor(y), floor)
    _close(got, jli.project_simplex_floor(jnp.asarray(y), floor), 1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_rho_estimate_matches_reference():
    rng = np.random.default_rng(1)
    a = (rng.exponential(size=(20, 3, 6)) * 1e-12).astype(np.float32)
    b = (a * np.exp(0.1 * rng.standard_normal(a.shape))).astype(np.float32)
    for x, y in ((a, b), (a, a), (a, rng.permutation(a.ravel()).reshape(a.shape))):
        _close(li_gd.rho_estimate(torch.tensor(x), torch.tensor(y)),
               jli.rho_estimate(jnp.asarray(x), jnp.asarray(y)), 1e-5)


@pytest.mark.parametrize("optimizer,stop_rule,split", [
    ("adam", "pgd", 0), ("adam", "pgd", 6), ("sgd", "pgd", 3), ("adam", "raw", 2),
])
def test_gd_solve_iters_and_optimum_match_reference(optimizer, stop_rule, split):
    jenv, tenv = _envs(16, 3, 8, seed=optimizer == "sgd")
    kw = dict(optimizer=optimizer, stop_rule=stop_rule, max_iters=60)
    jres = jli.gd_solve(jenv, jprof.nin(), jnp.int32(split), jmake_weights(16),
                        jli.cold_init(jenv), JGdConfig(**kw))
    tres = li_gd.gd_solve(tenv, tprof.nin(), split, make_weights(16, device="cpu"),
                          li_gd.cold_init(tenv), GdConfig(sinr_backend="kernel", **kw))
    assert int(tres.iters) == int(jres.iters)
    assert int(tres.opt_steps) == int(jres.opt_steps)
    _close(tres.gamma, jres.gamma)
    for k in KEYS:
        _close(tres.norm[k], jres.norm[k], 1e-4)


def test_gd_solve_resumes_adam_state_like_reference():
    """init_mom / init_steps resume the optimizer: same iterations and
    moments as the reference from the same carried state."""
    jenv, tenv = _envs(12, 3, 6, seed=4)
    cfg = dict(optimizer="adam", max_iters=40)
    first = jli.gd_solve(jenv, jprof.nin(), jnp.int32(4), jmake_weights(12),
                         jli.cold_init(jenv), JGdConfig(**cfg))
    mom = tuple(_t(m) for m in first.mom)
    jres = jli.gd_solve(jenv, jprof.nin(), jnp.int32(5), jmake_weights(12), first.norm,
                        JGdConfig(**cfg), init_mom=first.mom, init_steps=first.opt_steps)
    tres = li_gd.gd_solve(tenv, tprof.nin(), 5, make_weights(12, device="cpu"),
                          _t(first.norm), GdConfig(**cfg), init_mom=mom,
                          init_steps=torch.tensor(int(first.opt_steps)))
    assert int(tres.iters) == int(jres.iters)
    assert int(tres.opt_steps) == int(jres.opt_steps)
    _close(tres.gamma, jres.gamma)
    for a, b in zip(tres.mom, jres.mom):
        for k in KEYS:
            _close(a[k], b[k], 1e-4)


def test_chunked_stop_equals_stepwise_stop(monkeypatch):
    """Frozen steps change nothing: host reads every step and host reads
    every 8 steps give identical results; max_iters=0 runs no step."""
    _, tenv = _envs(10, 2, 5, seed=2)
    w, prof = make_weights(10, device="cpu"), tprof.nin()
    cfg = GdConfig(optimizer="adam", max_iters=45)
    monkeypatch.setattr(li_gd, "SYNC_EVERY", 1)
    li_gd.reset_counts()
    a = li_gd.gd_solve(tenv, prof, 3, w, li_gd.cold_init(tenv), cfg)
    assert li_gd.COUNTS["host_reads"] == li_gd.COUNTS["steps"] == int(a.iters)
    monkeypatch.setattr(li_gd, "SYNC_EVERY", 8)
    b = li_gd.gd_solve(tenv, prof, 3, w, li_gd.cold_init(tenv), cfg)
    assert int(a.iters) == int(b.iters) and bool(torch.equal(a.gamma, b.gamma))
    for k in KEYS:
        assert torch.equal(a.norm[k], b.norm[k]) and torch.equal(a.mom[1][k], b.mom[1][k])
    z = li_gd.gd_solve(tenv, prof, 3, w, li_gd.cold_init(tenv),
                       dataclasses.replace(cfg, max_iters=0))
    assert int(z.iters) == 0


@pytest.mark.parametrize("mode", ["chain", "plain", "warm"])
def test_gd_loop_modes_match_reference(mode):
    """Per-split iterations, utilities and, in warm mode, the reference's
    own used_warm choices (not a threshold on them)."""
    u, m = 14, 6
    jenv, tenv = _envs(u, 3, m, seed=7)
    cfg = dict(optimizer="adam", max_iters=50)
    jw, tw = jmake_weights(u), make_weights(u, device="cpu")
    kw_j, kw_t = {}, {}
    if mode == "plain":
        kw_j = kw_t = dict(chain=False)
    elif mode == "warm":
        prev = jli.gd_loop(jenv, jprof.nin(), jw, JGdConfig(**cfg))
        rng = np.random.default_rng(3)
        g_up = np.asarray(jenv.g_up) * np.exp(0.1 * rng.standard_normal(jenv.g_up.shape))
        g_dn = np.asarray(jenv.g_dn) * np.exp(0.1 * rng.standard_normal(jenv.g_dn.shape))
        jenv = dataclasses.replace(jenv, g_up=jnp.asarray(g_up, jnp.float32),
                                   g_dn=jnp.asarray(g_dn, jnp.float32))
        tenv = convert.env_from_numpy(g_up, g_dn, np.asarray(jenv.ap), device="cpu")
        decayed = tuple({k: 0.1 * v for k, v in mm.items()} for mm in prev.moms)
        kw_j = dict(warm=prev.norms, warm_mom=decayed, warm_steps=prev.opt_steps)
        kw_t = dict(warm=_t(prev.norms), warm_mom=tuple(_t(mm) for mm in decayed),
                    warm_steps=torch.tensor(np.asarray(prev.opt_steps)),
                    use_warm=torch.tensor(True))
    jl = jli.gd_loop(jenv, jprof.nin(), jw, JGdConfig(**cfg), **kw_j)
    tl = li_gd.gd_loop(tenv, tprof.nin(), tw, GdConfig(sinr_backend="kernel", **cfg),
                       **kw_t)
    assert tl.iters.tolist() == np.asarray(jl.iters).tolist()
    assert tl.used_warm.tolist() == np.asarray(jl.used_warm).tolist()
    assert tl.opt_steps.tolist() == np.asarray(jl.opt_steps).tolist()
    assert int(tl.total_iters) == int(jl.total_iters)
    _close(tl.gammas, jl.gammas)
    if mode == "warm":
        assert 0 < int(tl.used_warm.sum()) < len(tl.used_warm)   # both choices made


def test_warm_gate_closed_is_the_cold_chain():
    u = 10
    _, tenv = _envs(u, 2, 5, seed=8)
    w, prof = make_weights(u, device="cpu"), tprof.nin()
    cfg = GdConfig(optimizer="adam", max_iters=30)
    cold = li_gd.gd_loop(tenv, prof, w, cfg)
    warm = li_gd.gd_loop(tenv, prof, w, cfg, warm=cold.norms,
                         use_warm=torch.tensor(False))
    assert not warm.used_warm.any()
    assert torch.equal(warm.iters, cold.iters)
    assert torch.equal(warm.gammas, cold.gammas)


def test_rounding_matches_reference_exactly():
    u, m = 24, 8
    jenv, tenv = _envs(u, 4, m, seed=5)
    rng = np.random.default_rng(5)
    beta = rng.dirichlet(np.ones(m) * 0.3, size=u).astype(np.float32)
    beta[3] = 1.0 / m                      # a tied row: argmax takes index 0
    p_up = rng.uniform(1e-3, 0.3, size=u).astype(np.float32)
    p_dn = rng.uniform(0.1, 10.0, size=u).astype(np.float32)
    for got, want in zip(li_gd.round_beta(torch.tensor(beta)),
                         jli.round_beta(jnp.asarray(beta))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        li_gd.greedy_round_up(tenv, torch.tensor(beta), torch.tensor(p_up)).numpy(),
        np.asarray(jli.greedy_round_up(jenv, jnp.asarray(beta), jnp.asarray(p_up))))
    np.testing.assert_array_equal(
        li_gd.greedy_round_dn(tenv, torch.tensor(beta), torch.tensor(p_dn)).numpy(),
        np.asarray(jli.greedy_round_dn(jenv, jnp.asarray(beta), jnp.asarray(p_dn))))


@pytest.mark.parametrize("rounding", ["best", "greedy", "paper"])
def test_assemble_plan_from_reference_loop(rounding):
    """The same LoopResult assembles to the same plan."""
    u = 12
    jenv, tenv = _envs(u, 3, 6, seed=6)
    jw = jmake_weights(u)
    jl = jli.gd_loop(jenv, jprof.nin(), jw, JGdConfig(optimizer="adam", max_iters=30))
    tl = li_gd.LoopResult(
        gammas=torch.tensor(np.asarray(jl.gammas)), iters=torch.tensor(np.asarray(jl.iters)),
        norms=_t(jl.norms), total_iters=torch.tensor(int(jl.total_iters)),
        moms=tuple(_t(mm) for mm in jl.moms), opt_steps=torch.tensor(np.asarray(jl.opt_steps)),
        used_warm=torch.tensor(np.asarray(jl.used_warm)))
    jp = jli.assemble_plan(jenv, jl, jprof.nin(), rounding=rounding, w=jw)
    tp = li_gd.assemble_plan(tenv, tl, tprof.nin(), rounding=rounding,
                             w=make_weights(u, device="cpu"), backend="kernel")
    for field in ("s", "sub_up", "sub_dn", "iters", "rounding_violations"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(), np.asarray(getattr(jp, field)))
    for field in ("p_up", "p_dn", "r", "utility"):
        _close(getattr(tp, field), getattr(jp, field))


def test_solve_matches_reference():
    u = 10
    jenv, tenv = _envs(u, 2, 5, seed=9)
    cfg = dict(optimizer="adam", max_iters=30)
    jp = jli.solve(jenv, jprof.nin(), jmake_weights(u), JGdConfig(**cfg), method="gd")
    tp = li_gd.solve(tenv, tprof.nin(), make_weights(u, device="cpu"), GdConfig(**cfg),
                     method="gd")
    assert int(tp.s) == int(jp.s)
    assert tp.iters.tolist() == np.asarray(jp.iters).tolist()
    np.testing.assert_array_equal(tp.sub_up.numpy(), np.asarray(jp.sub_up))
    with pytest.raises(KeyError):
        li_gd.solve(tenv, tprof.nin(), make_weights(u, device="cpu"), method="newton")
