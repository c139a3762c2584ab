"""The port's scenarios package against the JAX package's, on the CPU.

The two draw from different generators (jax.random keys, torch.Generator),
so each function that draws is held through its deterministic core: the
test makes JAX's own draws from JAX's keys, split as the reference splits
them, and feeds them to the port's ``*_from`` core. Tolerances, and why:
- positions, waypoints, masks, cluster picks, AP positions and complex64
  coefficients: exact (the same float32 products and selects);
- a Gauss-Markov step and a waypoint step: 2 float32 ulps of each
  element's terms (XLA may fuse rho * h + c * w, and the port's vector
  norm may round the last bit differently);
- gains of the env made from one state: 1e-6 relative (float32 pow of the
  path loss, rounded in other places by XLA's and PyTorch's CPU math);
  the nearest-AP ids exactly.
The port's fleet ops are held member by member to its single ops on the
same seeds: the states to the bit, the env's gains to 1e-6 (PyTorch's
vectorized CPU pow rounds an element by its lane, which moves with the
batch), the AP ids exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.scenarios import Scenario as JScenario  # noqa: E402
from repro.scenarios import ScenarioConfig as JScenarioConfig  # noqa: E402
from repro.scenarios import churn as jchurn  # noqa: E402
from repro.scenarios import fading as jfading  # noqa: E402
from repro.scenarios import mobility as jmobility  # noqa: E402
from repro.scenarios import presets as jpresets  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.planning import member  # noqa: E402
from repro_torch.scenarios import Scenario, ScenarioConfig, churn, fading, mobility  # noqa: E402
from repro_torch.scenarios import presets  # noqa: E402
from repro_torch.scenarios.scenario import fold_in  # noqa: E402

ULP = float(np.finfo(np.float32).eps)


def _t(x):
    return torch.tensor(np.asarray(x))


def _pair(key, shape):
    kr, ki = jax.random.split(key)
    return _t(jax.random.normal(kr, shape)), _t(jax.random.normal(ki, shape))


def _positions(key, cfg):
    k_u, k_c, k_pick, k_off = jax.random.split(key, 4)
    u = cfg.n_users
    draws = {"uniform": _t(jax.random.uniform(k_u, (u, 2)))}
    if cfg.cluster_frac > 0.0:
        draws["centers"] = _t(jax.random.uniform(k_c, (cfg.n_clusters, 2)))
        draws["which"] = _t(jax.random.randint(k_pick, (u,), 0, cfg.n_clusters))
        draws["offsets"] = _t(jax.random.normal(k_off, (u, 2)))
    return draws


def _init_draws(key, cfg):
    """JAX's draws behind Scenario.init(key), split as the reference splits."""
    k_ap, k_pos, k_wp, k_up, k_dn = jax.random.split(key, 5)
    shape = (cfg.n_users, cfg.n_aps, cfg.n_sub)
    return {"ap_pos": _t(jax.random.uniform(k_ap, (cfg.n_aps, 2))),
            "pos": _positions(k_pos, cfg),
            "waypoint": _t(jax.random.uniform(k_wp, (cfg.n_users, 2))),
            "h_up": _pair(k_up, shape), "h_dn": _pair(k_dn, shape)}


def _step_draws(key, cfg):
    """JAX's draws behind Scenario.step(key, state)."""
    k_mob, k_up, k_dn, k_mask, k_churn = jax.random.split(key, 5)
    u, shape = cfg.n_users, (cfg.n_users, cfg.n_aps, cfg.n_sub)
    draws = {"waypoint": _t(jax.random.uniform(k_mob, (u, 2))),
             "h_up": _pair(k_up, shape), "h_dn": _pair(k_dn, shape)}
    if cfg.arrival_rate_hz > 0.0:
        k_pos, k_wp, k_cu, k_cd = jax.random.split(k_churn, 4)
        draws["mask"] = _t(jax.random.uniform(k_mask, (u,)))
        draws["churn"] = {"pos": _t(jax.random.uniform(k_pos, (u, 2))),
                          "waypoint": _t(jax.random.uniform(k_wp, (u, 2))),
                          "h_up": _pair(k_cu, shape), "h_dn": _pair(k_cd, shape)}
    return draws


def _port_state(js):
    return convert.scenario_state_from_numpy(
        np.asarray(js.mob.pos), np.asarray(js.mob.waypoint), np.asarray(js.ap_pos),
        np.asarray(js.h_up), np.asarray(js.h_dn), np.asarray(js.epoch), device="cpu")


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_state(got, want):
    _equal(got.mob.pos, want.mob.pos)
    _equal(got.mob.waypoint, want.mob.waypoint)
    _equal(got.ap_pos, want.ap_pos)
    _equal(got.h_up, want.h_up)
    _equal(got.h_dn, want.h_dn)
    assert got.epoch == int(np.unique(np.asarray(want.epoch))[0])


def _ulp_close(got, want, scale):
    got, want, scale = np.asarray(got), np.asarray(want), np.asarray(scale)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 2 * ULP * scale), np.max(np.abs(got - want) / scale)


# -- constants ------------------------------------------------------------
@pytest.mark.parametrize("doppler,dt", [(9.0, 0.01), (6.0, 0.01), (0.02, 1.0),
                                        (200.0, 0.05), (5.0, 0.1), (30.0, 0.01)])
def test_jakes_rho_matches_reference(doppler, dt):
    assert fading.jakes_rho(doppler, dt) == jfading.jakes_rho(doppler, dt)


def test_presets_match_reference():
    assert presets.names() == jpresets.names()
    for name in presets.names():
        ours, ref = presets.get(name), jpresets.get(name)
        for f in dataclasses.fields(ScenarioConfig):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if f.name in ("radio", "comp"):
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, (name, f.name)
        assert ours.rho == ref.rho and ours.side_m == ref.side_m
    with pytest.raises(KeyError, match="unknown preset"):
        presets.get("moon_base")


# -- deterministic cores fed JAX's draws ---------------------------------------
def test_fading_cores_match_reference():
    key = jax.random.PRNGKey(3)
    shape = (7, 3, 5)
    h = jfading.init_coeffs(key, shape)
    _equal(fading.coeffs_from(*_pair(key, shape)), h)
    k_step = jax.random.PRNGKey(4)
    w = fading.coeffs_from(*_pair(k_step, shape))
    for rho in (0.92, 0.0, 1.0):
        want = jfading.gauss_markov_step(k_step, h, rho)
        got = fading.gauss_markov_from(_t(h), w, rho)
        c = np.sqrt(max(1.0 - rho * rho, 0.0))
        for part in ("real", "imag"):
            scale = (rho * np.abs(getattr(np.asarray(h), part))
                     + c * np.abs(getattr(w.numpy(), part)))
            _ulp_close(getattr(got, part), getattr(np.asarray(want), part), scale)
    _equal(fading.power_gain(_t(h)), jfading.power_gain(h))
    assert fading.power_gain(_t(h)).dtype == torch.float32


@pytest.mark.parametrize("cluster_frac", [0.0, 0.5, 0.9])
def test_mobility_cores_match_reference(cluster_frac):
    jcfg = JScenarioConfig(n_users=23, n_aps=4, cluster_frac=cluster_frac, n_clusters=3,
                           cluster_radius_m=40.0)
    key = jax.random.PRNGKey(5)
    want = jmobility.init_positions(key, jcfg.n_users, jcfg.side_m, jcfg.cluster_frac,
                                    jcfg.n_clusters, jcfg.cluster_radius_m)
    pos = mobility.positions_from(_positions(key, jcfg), jcfg.side_m, cluster_frac,
                                  jcfg.cluster_radius_m)
    _equal(pos, want)
    k_wp = jax.random.PRNGKey(6)
    jstate = jmobility.init_state(k_wp, want, jcfg.side_m)
    _equal(_t(jax.random.uniform(k_wp, (jcfg.n_users, 2))) * jcfg.side_m, jstate.waypoint)
    # Several steps from the reference's state: far users move, near ones
    # arrive and take fresh waypoints.
    state = mobility.MobilityState(pos=_t(jstate.pos), waypoint=_t(jstate.waypoint))
    for t, (speed, dt) in enumerate(((1.4, 0.01), (30.0, 5.0), (0.0, 1.0))):
        k = jax.random.PRNGKey(10 + t)
        jstate = jmobility.waypoint_step(k, jstate, speed, dt, jcfg.side_m)
        state = mobility.waypoint_step_from(state, _t(jax.random.uniform(k, (jcfg.n_users, 2))),
                                            speed, dt, jcfg.side_m)
        scale = np.abs(np.asarray(jstate.pos)) + speed * dt
        _ulp_close(state.pos, jstate.pos, scale)
        _equal(state.waypoint, jstate.waypoint)
        state = mobility.MobilityState(pos=_t(jstate.pos), waypoint=_t(jstate.waypoint))


def test_churn_cores_match_reference():
    key = jax.random.PRNGKey(7)
    u, shape, side = 400, (400, 3, 4), 433.0
    for rate, dt in ((2.0, 0.01), (2000.0, 1.0), (0.0, 1.0), (1e6, 1.0)):
        want = jchurn.replacement_mask(key, u, rate, dt)
        got = churn.mask_from(_t(jax.random.uniform(key, (u,))), u, rate, dt)
        _equal(got, want)
    mask = jchurn.replacement_mask(key, u, 200.0, 1.0)       # p = 0.5
    assert 0 < int(np.sum(mask)) < u
    jmob = jmobility.MobilityState(pos=jax.random.uniform(jax.random.PRNGKey(1), (u, 2)),
                                   waypoint=jax.random.uniform(jax.random.PRNGKey(2), (u, 2)))
    h_up = jfading.init_coeffs(jax.random.PRNGKey(3), shape)
    h_dn = jfading.init_coeffs(jax.random.PRNGKey(4), shape)
    k_churn = jax.random.PRNGKey(8)
    w_mob, w_up, w_dn = jchurn.apply_churn(k_churn, mask, jmob, h_up, h_dn, side)
    k_pos, k_wp, k_cu, k_cd = jax.random.split(k_churn, 4)
    draws = {"pos": _t(jax.random.uniform(k_pos, (u, 2))),
             "waypoint": _t(jax.random.uniform(k_wp, (u, 2))),
             "h_up": _pair(k_cu, shape), "h_dn": _pair(k_cd, shape)}
    mob, g_up, g_dn = churn.apply_churn_from(
        draws, _t(mask), mobility.MobilityState(_t(jmob.pos), _t(jmob.waypoint)),
        _t(h_up), _t(h_dn), side)
    for a, b in ((mob.pos, w_mob.pos), (mob.waypoint, w_mob.waypoint), (g_up, w_up),
                 (g_dn, w_dn)):
        _equal(a, b)


@pytest.mark.parametrize("name", ["dense_urban", "hotspot", "iot_massive", "highway"])
def test_scenario_init_step_env_match_reference(name):
    """Scenario.init and three steps (churn where the preset has it) from
    JAX's draws equal JAX's states; the port steps on from JAX's own state
    (carried across with convert.scenario_state_from_numpy); the env of
    each state has the same AP ids and the gains to 1e-6."""
    jcfg = jpresets.get(name)
    jsc, sc = JScenario(jcfg), Scenario(presets.get(name), device="cpu")
    key = jax.random.PRNGKey(11)
    jstate = jsc.init(key)
    _assert_state(sc.init_from(_init_draws(key, jcfg)), jstate)
    for t in range(3):
        k = jax.random.PRNGKey(50 + t)
        state = _port_state(jstate)
        jstate = jsc.step(k, jstate)
        stepped = sc.step_from(_step_draws(k, jcfg), state)
        _equal(stepped.mob.waypoint, jstate.mob.waypoint)
        _equal(stepped.ap_pos, jstate.ap_pos)
        assert stepped.epoch == int(jstate.epoch) == t + 1
        scale = np.abs(np.asarray(jstate.mob.pos)) + jcfg.speed_mps * jcfg.epoch_dt_s
        _ulp_close(stepped.mob.pos, jstate.mob.pos, scale)
        rho = jcfg.rho
        c = np.sqrt(max(1.0 - rho * rho, 0.0))
        for got, want, prev in ((stepped.h_up, jstate.h_up, state.h_up),
                                (stepped.h_dn, jstate.h_dn, state.h_dn)):
            for part in ("real", "imag"):
                # a churned slot's coefficient is a fresh draw (scale 1)
                scale = rho * np.abs(getattr(prev.numpy(), part)) + c * 5.0 + 1.0
                _ulp_close(getattr(got, part), getattr(np.asarray(want), part), scale)
        env, jenv = sc.env(_port_state(jstate)), jsc.env(jstate)
        _equal(env.ap, jenv.ap)
        np.testing.assert_allclose(env.g_up.numpy(), np.asarray(jenv.g_up), rtol=1e-6)
        np.testing.assert_allclose(env.g_dn.numpy(), np.asarray(jenv.g_dn), rtol=1e-6)
        assert env.radio == sc.cfg.radio and env.g_dn.is_contiguous()


def test_reference_fleet_state_steps_on_in_the_port():
    """A JAX init_many fleet carried across steps on with the port's core
    from JAX's draws to JAX's step_many, member by member; env_many gives
    the reference's AP ids."""
    jcfg = jpresets.get("dense_urban")
    jsc, sc = JScenario(jcfg), Scenario(presets.get("dense_urban"), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    jstates = jsc.init_many(keys)
    states = _port_state(jstates)
    assert states.h_up.shape == (3, 24, 6, 8) and states.epoch == 0
    step_keys = jax.random.split(jax.random.PRNGKey(9), 3)
    jnext = jsc.step_many(step_keys, jstates)
    draws = [_step_draws(k, jcfg) for k in step_keys]
    from repro_torch.scenarios.scenario import _stack
    nxt = sc.step_from(_stack(draws), states)
    _equal(nxt.mob.waypoint, jnext.mob.waypoint)
    _ulp_close(nxt.mob.pos, jnext.mob.pos, np.abs(np.asarray(jnext.mob.pos)) + 1.0)
    envs, jenvs = sc.env_many(nxt), jsc.env_many(jnext)
    _equal(envs.ap, jenvs.ap)
    with pytest.raises(ValueError, match="epochs differ"):
        convert.scenario_state_from_numpy(*(np.asarray(x) for x in (
            jstates.mob.pos, jstates.mob.waypoint, jstates.ap_pos, jstates.h_up,
            jstates.h_dn)), np.array([0, 1, 0]))


# -- the port's own fleets and seeding ----------------------------------------
def _assert_member(fleet_state, i, single):
    one = member(fleet_state, i)
    for a, b in ((one.mob.pos, single.mob.pos), (one.mob.waypoint, single.mob.waypoint),
                 (one.ap_pos, single.ap_pos), (one.h_up, single.h_up),
                 (one.h_dn, single.h_dn)):
        assert torch.equal(a, b)
    assert one.epoch == single.epoch


@pytest.mark.parametrize("name", ["dense_urban", "highway"])
def test_fleet_ops_equal_single_ops_member_by_member(name):
    sc = Scenario(presets.get(name), device="cpu")
    seeds = [3, 1, 4]
    states = sc.init_many(seeds)
    singles = [sc.init(s) for s in seeds]
    rho = [0.5, 0.9, 0.99]
    for t in range(3):
        for i, s in enumerate(singles):
            _assert_member(states, i, s)
        envs = sc.env_many(states)
        assert envs.fleet == 3 and envs.g_up.shape == (3, *sc.env(singles[0]).g_up.shape)
        for i, s in enumerate(singles):
            env = sc.env(s)
            assert torch.equal(envs.ap[i], env.ap)
            np.testing.assert_allclose(envs.g_up[i].numpy(), env.g_up.numpy(), rtol=1e-6)
            np.testing.assert_allclose(envs.g_dn[i].numpy(), env.g_dn.numpy(), rtol=1e-6)
        per_member = rho if t == 1 else None
        states = sc.step_many(seeds, states, rho=per_member)
        singles = [sc.step(s, st, rho=None if per_member is None else per_member[i])
                   for i, (s, st) in enumerate(zip(seeds, singles))]
    with pytest.raises(ValueError, match="one seed per member"):
        sc.step_many(seeds[:2], states)
    with pytest.raises(ValueError, match="one value per member"):
        sc.step_many(seeds, states, rho=[0.5])


def test_draws_are_counter_based():
    """A member's epoch-t draws depend only on its seed and t: the same
    (seed, t) gives the same step whatever state it is applied to, another
    seed or epoch gives other draws, and a generator passed in is drawn
    from as it stands."""
    sc = Scenario(presets.get("hotspot"), device="cpu")
    a, b = sc.init(7), sc.init(8)
    assert not torch.equal(a.h_up, b.h_up)
    d1 = sc.step_draws(sc.generator(7, 5))
    d2 = sc.step_draws(sc.generator(7, 5))
    assert all(torch.equal(x, y) for x, y in zip(d1["h_up"], d2["h_up"]))
    d3 = sc.step_draws(sc.generator(7, 6))
    assert not torch.equal(d1["h_up"][0], d3["h_up"][0])
    assert len({fold_in(s, t) for s in range(20) for t in range(20)}) == 400
    # the step into epoch 1 from two different states uses the same draws
    s1, s2 = sc.step(3, a), sc.step(3, b)
    w = fading.coeffs_from(*sc.step_draws(sc.generator(3, 1))["h_up"])
    rho = sc.cfg.rho
    assert torch.equal(s1.h_up, fading.gauss_markov_from(a.h_up, w, rho))
    assert torch.equal(s2.h_up, fading.gauss_markov_from(b.h_up, w, rho))
    gen = torch.Generator().manual_seed(0)
    g_state = sc.init(gen)
    assert torch.equal(g_state.h_up, sc.init(torch.Generator().manual_seed(0)).h_up)
    envs = sc.episode_list(5, 4)
    assert len(envs) == 4 and all(e.g_up.shape == envs[0].g_up.shape for e in envs)
    assert torch.equal(envs[1].g_up, sc.env(sc.step(5, sc.init(5))).g_up)


def test_scenario_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scenario(ScenarioConfig())
