"""The planner's fleet over a device mesh on the CPU: PlannerEngine's
plan_many_sharded / replan_many_sharded on 4 gloo ranks (pshard.fleet_mesh,
pshard.shard_fleet), against the JAX package's vmapped plan_many /
replan_many and the port's own unsharded plan_many / replan_many, at
tests/test_fleet_sharding.py's configuration (U=6, N=2, M=3, Adam
max_iters=80, warm_rho_min=0.9, a fleet of 8; the second epoch's fading
rho 0.999 for members 0-3 and 0.0 for 4-7, so the warm gate splits it).

The JAX package's own sharded kinds do not run on this container's JAX
(ROADMAP.md section 3), so the port is held to the reference's vmapped
path with the reference's own yardstick (test_fleet_sharding.py
_assert_members_match): s exact, utility within 1e-4 absolute, total
iterations within 2, warm_rho within 1e-5. Against the port's unsharded
fleet every leaf is equal to the bit: a rank runs its members through the
same programs, and a member's arithmetic does not depend on the others.

The ranks start once for the module (launch.mesh.spawn, a file:// rendezvous
under the module's temporary directory); the JAX reference and the port's
unsharded fleet run in this process meanwhile.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.core import GdConfig  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core.types import make_weights, tree_flatten  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.planning import PlannerEngine, member  # noqa: E402
from repro_torch.planning.engine import KINDS  # noqa: E402
from repro_torch.pshard import fleet_mesh, shard_fleet, unshard  # noqa: E402

FLEET = 8
WORLD = 4
U, N, M = 6, 2, 3
ADAM = dict(step_size=1e-2, eps=1e-4, max_iters=80, optimizer="adam")
RHO_MIN = 0.9


def port_env(g_up, g_dn, ap, radio, comp):
    return convert.env_from_numpy(g_up, g_dn, ap, radio, comp, device="cpu")


def _engine():
    return PlannerEngine(tprof.nin(), weights=make_weights(U, device="cpu"),
                         cfg=GdConfig(**ADAM), warm_rho_min=RHO_MIN, device="cpu")


def _numpy(st):
    """A fleet PlanState as numpy: every leaf, and the fields the reference
    comparison reads."""
    leaves = [x.numpy().copy() for x in tree_flatten(st)[0] if isinstance(x, torch.Tensor)]
    named = dict(s=st.plan.s, utility=st.plan.utility, total_iters=st.total_iters,
                 warm_rho=st.warm_rho)
    return dict(leaves=leaves, **{k: None if v is None else v.numpy().copy()
                                  for k, v in named.items()})


def fleet_rank(rank: int, env0, env1, out_path: str) -> None:
    """One rank: plan and replan the fleet on a 4-rank fleet mesh, from DTensor
    envs and from whole ones; the checks that need the mesh. Rank 0 writes
    the gathered results to out_path."""
    from torch.distributed.tensor import DTensor
    sh = _engine().shard(fleet_mesh(device="cpu"))
    envs0, envs1 = port_env(*env0), port_env(*env1)
    plan = sh.plan_many(shard_fleet(envs0, sh.mesh))
    warm = sh.replan_many(plan, shard_fleet(envs1, sh.mesh))
    local = plan.plan.s.to_local().shape[0]
    assert all(isinstance(x, DTensor) for x in tree_flatten(warm)[0]
               if isinstance(x, torch.Tensor))
    # whole tensors that every rank holds alike take the same path
    plan_w = sh.plan_many(envs0)
    warm_w = sh.replan_many(unshard(plan_w), envs1)
    try:
        sh.plan_many(port_env(*(x[:6] if i < 3 else x for i, x in enumerate(env0))))
        divisible = None
    except ValueError as e:
        divisible = str(e)
    try:
        sh.mesh = None
        read_only = False
    except AttributeError:
        read_only = True
    single = member(envs0, 0)
    one = sh.replan(sh.plan(single), single)
    out = dict(plan=_numpy(unshard(plan)), warm=_numpy(unshard(warm)),
               plan_w=_numpy(unshard(plan_w)), warm_w=_numpy(unshard(warm_w)),
               local=local, divisible=divisible, read_only=read_only,
               plain_mesh=sh.shard(None).mesh, one_s=int(one.plan.s),
               one_rho=float(one.warm_rho), kinds=sorted(k[0] for k in sh.cache_keys()),
               members=sh._members(FLEET))
    gathered = [None] * WORLD
    torch.distributed.all_gather_object(gathered, out)
    if rank == 0:
        torch.save(gathered, out_path)


@pytest.fixture(scope="module")
def rollout(tmp_path_factory):
    """Two epochs of the fleet: on 4 ranks (a thread waits for them), the
    JAX package's vmapped engine and the port's unsharded engine."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro.core import GdConfig as JGdConfig
    from repro.core import make_weights as jweights
    from repro.core import profiles as jprof
    from repro.planning import PlannerEngine as JEngine
    from repro.planning import member as jmember
    from repro.scenarios import Scenario as JScenario
    from repro.scenarios import ScenarioConfig as JScenarioConfig

    sc = JScenario(JScenarioConfig(n_users=U, n_aps=N, n_sub=M, speed_mps=0.0,
                                   arrival_rate_hz=0.0))
    states = sc.init_many(jax.random.split(jax.random.PRNGKey(0), FLEET))
    jenvs0 = sc.env_many(states)
    rho = jnp.array([0.999] * 4 + [0.0] * 4)
    states = sc.step_many(jax.random.split(jax.random.PRNGKey(1), FLEET), states, rho=rho)
    jenvs1 = sc.env_many(states)
    consts = jmember(jenvs0, 0)

    def as_np(e):
        return (np.asarray(e.g_up), np.asarray(e.g_dn), np.asarray(e.ap), consts.radio,
                consts.comp)
    env0, env1 = as_np(jenvs0), as_np(jenvs1)

    tmp = tmp_path_factory.mktemp("fleet_sharding")
    out_path = str(tmp / "ranks.pt")
    failed = []

    def ranks():
        try:
            tmesh.spawn(fleet_rank, WORLD, (env0, env1, out_path),
                        init_method=f"file://{tmp / 'rendezvous'}", device="cpu")
        except Exception as e:  # surfaced below
            failed.append(e)
    thread = threading.Thread(target=ranks)
    thread.start()

    vm = JEngine(jprof.nin(), weights=jweights(U), cfg=JGdConfig(**ADAM), warm_rho_min=RHO_MIN)
    jplan = vm.plan_many(jenvs0)
    jwarm = vm.replan_many(jplan, jenvs1)
    eng = _engine()
    plan = eng.plan_many(port_env(*env0))
    warm = eng.replan_many(plan, port_env(*env1))
    thread.join(timeout=240)
    assert not thread.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    ranks_out = torch.load(out_path, weights_only=False)
    return dict(jplan=jplan, jwarm=jwarm, plan=_numpy(plan), warm=_numpy(warm),
                ranks=ranks_out)


def _assert_members_match(want, got):
    """The reference's per-member yardstick (test_fleet_sharding.py):
    s exact, utility within 1e-4 absolute, total iterations within 2."""
    s, util, iters = (np.asarray(want.plan.s), np.asarray(want.plan.utility),
                      np.asarray(want.total_iters))
    g_s, g_util, g_iters = got
    for i in range(FLEET):
        assert int(g_s[i]) == int(s[i]), i
        assert float(g_util[i]) == pytest.approx(float(util[i]), abs=1e-4), i
        assert abs(int(g_iters[i]) - int(iters[i])) <= 2, i


def _fields(rollout, which: str, rank: int = 0):
    """(s, utility, total_iters) of a gathered rank result, as numpy."""
    st = rollout["ranks"][rank][which]
    return st["s"], st["utility"], st["total_iters"]


def test_plan_many_sharded_matches_the_reference(rollout):
    _assert_members_match(rollout["jplan"], _fields(rollout, "plan"))


def test_replan_many_sharded_matches_the_reference(rollout):
    _assert_members_match(rollout["jwarm"], _fields(rollout, "warm"))


def test_warm_gate_per_member_agrees_and_splits_the_fleet(rollout):
    """The rho estimate agrees with the reference within 1e-5 on every
    member, and the gate splits the fleet: members 0-3 stay warm, some of
    4-7 run the cold chain."""
    got = rollout["ranks"][0]["warm"]["warm_rho"]
    want = np.asarray(rollout["jwarm"].warm_rho)
    assert got.shape == (FLEET,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    gate = got >= RHO_MIN
    assert gate[:4].all(), got
    assert not gate[4:].all(), got


@pytest.mark.parametrize("which", ["plan", "warm"])
def test_sharded_fleet_equals_the_unsharded_fleet_to_the_bit(rollout, which):
    """Every leaf of the sharded result (gathered) equals the port's
    unsharded plan_many / replan_many to the bit, from DTensor envs and
    from whole ones, on both ranks."""
    want = rollout[which]
    for r in range(WORLD):
        for key in (which, f"{which}_w"):
            got = rollout["ranks"][r][key]["leaves"]
            assert len(got) == len(want["leaves"])
            for i, (g, w) in enumerate(zip(got, want["leaves"])):
                assert g.dtype == w.dtype and g.shape == w.shape, (key, i)
                assert np.array_equal(g, w), (r, key, i)


def test_each_rank_plans_its_contiguous_members(rollout):
    for r in range(WORLD):
        out = rollout["ranks"][r]
        assert out["members"] == (r * FLEET // WORLD, (r + 1) * FLEET // WORLD)
        assert out["local"] == FLEET // WORLD
        assert out["kinds"] == ["plan", "plan_many_sharded", "replan",
                                "replan_many_sharded"]
    assert "plan_many_sharded" in KINDS and "replan_many_sharded" in KINDS


def test_fleet_must_divide_over_the_mesh(rollout):
    msg = rollout["ranks"][0]["divisible"]
    assert msg is not None and "divisible" in msg and "fleet size 6" in msg, msg


def test_mesh_is_read_only_and_shard_none_is_plain(rollout):
    for r in range(WORLD):
        assert rollout["ranks"][r]["read_only"]
        assert rollout["ranks"][r]["plain_mesh"] is None


def test_mesh_engine_single_scenario_still_works(rollout):
    """A mesh engine's plan / replan of one scenario: member 0 of the fleet,
    replanned on its own env (rho 1, the gate open)."""
    for r in range(WORLD):
        out = rollout["ranks"][r]
        assert out["one_s"] == int(rollout["plan"]["s"][0])
        assert out["one_rho"] == pytest.approx(1.0, abs=1e-6)


def test_fleet_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        fleet_mesh(device="cpu")
