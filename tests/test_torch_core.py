"""The port's core (types, profiles, convert, channel) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the port
runs on the CPU (device="cpu"). Profiles are plain arithmetic and must be
equal exactly; rates and their gradients agree to 1e-5 (float32, sums taken
in another order)."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import channel as jch  # noqa: E402
from repro.core import make_env as jmake_env  # noqa: E402
from repro.core import profiles as jprof  # noqa: E402
from repro.core.types import make_weights as jmake_weights  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import make_env, make_weights  # noqa: E402
from repro_torch.core import profiles as tprof  # noqa: E402
from repro_torch.core.types import (  # noqa: E402
    ComputeConstants,
    ProfileShapeError,
    RadioConstants,
)

TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _case(u, n, m, seed):
    """(jax env, port env, beta, p_up, p_dn) from the JAX sampler's draws."""
    jenv = jmake_env(jax.random.PRNGKey(seed), n_users=u, n_aps=n, n_sub=m)
    tenv = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp,
                                  device="cpu")
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(m), size=u).astype(np.float32)
    p_up = rng.uniform(1e-3, 0.3, size=u).astype(np.float32)
    p_dn = rng.uniform(0.1, 10.0, size=u).astype(np.float32)
    return jenv, tenv, beta, p_up, p_dn


_LM = types.SimpleNamespace(name="lm_moe", d_model=64, n_heads=4, n_kv_heads=2,
                            d_ff=128, n_layers=5, vocab_size=1000, window=16,
                            n_experts=4, top_k=2, n_shared_experts=1,
                            moe_d_ff=32, moe_every=2)


@pytest.mark.parametrize("which", ["nin", "yolov2", "vgg16", "lm"])
def test_profiles_equal_reference_exactly(which):
    if which == "lm":
        pj, pt = jprof.from_arch_config(_LM, 32, 2), tprof.from_arch_config(_LM, 32, 2)
        assert jprof.lm_block_flops(_LM, 32) == tprof.lm_block_flops(_LM, 32)
    else:
        pj, pt = getattr(jprof, which)(), getattr(tprof, which)()
    assert pt.name == pj.name and pt.n_layers == pj.n_layers
    for field in ("fl", "w", "m_down"):
        a = np.asarray(getattr(pj, field))
        b = getattr(pt, field).numpy()
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(pt.prefix_flops().numpy(), np.asarray(pj.prefix_flops()))
    np.testing.assert_array_equal(pt.suffix_flops().numpy(), np.asarray(pj.suffix_flops()))


def test_profile_like_and_validate():
    p = tprof.nin()
    q = p.like(p.fl * 2, p.w, p.m_down.numpy())
    assert q.name == "nin" and q.fl.dtype == torch.float32
    with pytest.raises(ProfileShapeError, match="layers"):
        p.validate_like(tprof.vgg16())
    with pytest.raises(ProfileShapeError, match="field 'w'"):
        p.validate_like(dataclasses.replace(p, w=p.w.double()))
    with pytest.raises(ProfileShapeError, match="named"):
        p.validate_like(dataclasses.replace(p, name="other"))


def test_convert_round_trip():
    """JAX objects -> numpy -> port -> numpy is the identity, constants
    included; a reference PlanState payload converts leaf for leaf."""
    radio = dataclasses.replace(jmake_env(jax.random.PRNGKey(0), 4, 2, 3).radio,
                                p_up_max_w=0.2, beta_min=2e-3)
    jenv = jmake_env(jax.random.PRNGKey(3), 10, 3, 5, radio=radio)
    tenv = convert.env_from_numpy(np.asarray(jenv.g_up), np.asarray(jenv.g_dn),
                                  np.asarray(jenv.ap), jenv.radio, jenv.comp,
                                  device="cpu")
    assert tenv.radio == RadioConstants(**dataclasses.asdict(jenv.radio))
    assert tenv.comp == ComputeConstants(**dataclasses.asdict(jenv.comp))
    assert tenv.ap.dtype == torch.int32 and tenv.g_up.dtype == torch.float32
    back = convert.to_numpy(tenv)
    for field in ("g_up", "g_dn", "ap"):
        np.testing.assert_array_equal(back[field], np.asarray(getattr(jenv, field)))
    assert tenv.noise_up == jenv.noise_up and tenv.noise_dn == jenv.noise_dn
    np.testing.assert_array_equal(tenv.own_gain_up().numpy(), np.asarray(jenv.own_gain_up()))
    np.testing.assert_array_equal(tenv.own_gain_dn().numpy(), np.asarray(jenv.own_gain_dn()))
    np.testing.assert_array_equal(tenv.same_cell().numpy(), np.asarray(jenv.same_cell()))

    pj = jprof.nin()
    pt = convert.profile_from_numpy(np.asarray(pj.fl), np.asarray(pj.w),
                                    np.asarray(pj.m_down), pj.name, device="cpu")
    assert convert.to_numpy(pt)["name"] == "nin"
    np.testing.assert_array_equal(convert.to_numpy(pt)["fl"], np.asarray(pj.fl))
    wj = jmake_weights(10, 0.3)
    wt = convert.weights_from_numpy(np.asarray(wj.w_T), np.asarray(wj.w_E), device="cpu")
    np.testing.assert_array_equal(wt.w_E.numpy(), np.asarray(wj.w_E))
    np.testing.assert_array_equal(make_weights(10, 0.3, device="cpu").w_E.numpy(),
                                  np.asarray(wj.w_E))

    rng = np.random.default_rng(0)
    norms = {k: rng.random((10, 4, 3)).astype(np.float32) for k in ("beta_up", "beta_dn")}
    norms.update({k: rng.random((10, 4)).astype(np.float32) for k in ("p_up", "p_dn", "r")})
    state = convert.plan_state_from_numpy(norms, moms=(norms, norms),
                                          opt_steps=np.arange(10, dtype=np.int32),
                                          gains=np.asarray(jenv.g_up), device="cpu")
    for k, v in norms.items():
        np.testing.assert_array_equal(state.norms[k].numpy(), v)
        np.testing.assert_array_equal(state.moms[1][k].numpy(), v)
    assert state.opt_steps.dtype == torch.int32 and state.plan is None


@pytest.mark.parametrize("u,n,m,seed", [(8, 2, 4, 0), (13, 3, 6, 1), (9, 1, 12, 2)])
@pytest.mark.parametrize("link", ["up", "dn"])
def test_einsum_sinr_rates_and_grads_match_reference(u, n, m, seed, link):
    jenv, tenv, beta, p_up, p_dn = _case(u, n, m, seed)
    p = p_up if link == "up" else p_dn
    jsinr, tsinr = ((jch.uplink_sinr, tch.uplink_sinr) if link == "up"
                    else (jch.downlink_sinr, tch.downlink_sinr))
    jrate, trate = ((jch.uplink_rates, tch.uplink_rates) if link == "up"
                    else (jch.downlink_rates, tch.downlink_rates))
    bj, pj = jnp.asarray(beta), jnp.asarray(p)
    bt, pt = torch.tensor(beta, requires_grad=True), torch.tensor(p, requires_grad=True)
    _close(tsinr(tenv, bt, pt, backend="einsum").detach(),
           jsinr(jenv, bj, pj, backend="einsum"))
    got = trate(tenv, bt, pt, backend="einsum")
    _close(got.detach(), jrate(jenv, bj, pj, backend="einsum"))
    want = jax.grad(lambda b, q: jnp.sum(jrate(jenv, b, q, backend="einsum")),
                    argnums=(0, 1))(bj, pj)
    for w, g in zip(want, torch.autograd.grad(got.sum(), [bt, pt])):
        _close(g, w)


def test_user_rates_floor_and_oma_match_reference():
    jenv, tenv, beta, p_up, p_dn = _case(12, 3, 5, 4)
    args_j = [jnp.asarray(x) for x in (beta, beta, p_up, p_dn)]
    args_t = [torch.tensor(x) for x in (beta, beta, p_up, p_dn)]
    for a, b in zip(tch.user_rates(tenv, *args_t, backend="einsum"),
                    jch.user_rates(jenv, *args_j, backend="einsum")):
        _close(a, b)
    for a, b in zip(tch.oma_rates(tenv, args_t[2], args_t[3]),
                    jch.oma_rates(jenv, args_j[2], args_j[3])):
        _close(a, b)
    # the floor is a binary maximum: at a tie the gradient splits evenly
    zero = torch.zeros((3, 2), requires_grad=True)
    r = torch.maximum(zero.sum(-1) + 1e-9, zero.new_tensor(1e-9)).sum()
    (g,) = torch.autograd.grad(r, [zero])
    want = jax.grad(lambda z: jnp.sum(jnp.maximum(jnp.sum(z, -1) + 1e-9, 1e-9)))(
        jnp.zeros((3, 2)))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_set_sinr_backend_round_trip():
    prev = tch.set_sinr_backend("kernel")
    try:
        assert tch._SINR_BACKEND == "kernel"
        with pytest.raises(ValueError, match="backend"):
            tch.set_sinr_backend("pallas")
    finally:
        tch.set_sinr_backend(prev)


def test_make_env_shapes_and_distribution():
    u, n, m, seed = 300, 4, 16, 7
    env = make_env(u, n, m, seed=seed, device="cpu")
    assert env.g_up.shape == (u, n, m) and env.g_dn.shape == (n, u, m)
    assert env.g_up.dtype == torch.float32 and env.ap.dtype == torch.int32
    assert bool((env.g_up > 0).all()) and bool((env.g_dn > 0).all())
    # same seed, same draws; positions are drawn first (APs, then users)
    again = make_env(u, n, m, seed=seed, device="cpu")
    assert torch.equal(again.g_up, env.g_up)
    gen = torch.Generator().manual_seed(seed)
    side = env.radio.cell_radius_m * max(1.0, n**0.5)
    ap_pos = torch.rand((n, 2), generator=gen) * side
    user_pos = torch.rand((u, 2), generator=gen) * side
    d = torch.linalg.norm(user_pos[:, None] - ap_pos[None], dim=-1).clamp_min(1.0)
    assert torch.equal(env.ap, torch.argmin(d, dim=1).to(torch.int32))
    # Rayleigh fading: g / path-loss ~ Exp(1), mean 1, sd 1
    path = d ** (-env.radio.path_loss_exp)
    fad = (env.g_up / path[:, :, None]).flatten()
    assert abs(float(fad.mean()) - 1.0) < 0.05 and abs(float(fad.std()) - 1.0) < 0.05
    fad_dn = (env.g_dn.transpose(0, 1) / path[:, :, None]).flatten()
    assert abs(float(fad_dn.mean()) - 1.0) < 0.05


def test_make_env_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: device=None resolves to the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_env(4, 2, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_weights(4)


def test_env_to_device_and_dims():
    _, tenv, *_ = _case(6, 2, 3, 0)
    assert (tenv.n_users, tenv.n_aps, tenv.n_sub) == (6, 2, 3)
    assert tenv.to("cpu").device.type == "cpu"


@pytest.mark.parametrize("split", [0, 4, 9])
def test_utility_delay_energy_match_reference(split):
    import importlib
    from repro.core.types import GdVars as JVars
    from repro_torch.core.types import GdVars
    # the packages re-export the function `utility` over the module's name
    jut = importlib.import_module("repro.core.utility")
    tut = importlib.import_module("repro_torch.core.utility")
    jenv, tenv, beta, p_up, p_dn = _case(10, 3, 5, split)
    r = np.linspace(1.0, 16.0, 10).astype(np.float32)
    jv = JVars(*(jnp.asarray(x) for x in (beta, beta, p_up, p_dn, r)))
    tv = GdVars(*(torch.tensor(x) for x in (beta, beta, p_up, p_dn, r)))
    jw, tw = jmake_weights(10, 0.3), make_weights(10, 0.3, device="cpu")
    pj, pt = jprof.nin(), tprof.nin()
    for a, b in zip(tut.delay_energy(tenv, pt, split, tv, backend="kernel"),
                    jut.delay_energy(jenv, pj, jnp.int32(split), jv, backend="einsum")):
        _close(a, b)
    _close(tut.per_user_utility(tenv, pt, split, tv, tw, backend="kernel"),
           jut.per_user_utility(jenv, pj, jnp.int32(split), jv, jw, backend="einsum"))
    _close(tut.utility(tenv, pt, torch.tensor(split), tv, tw),
           jut.utility(jenv, pj, jnp.int32(split), jv, jw))
    f_t = tut.split_constants(pt, torch.tensor(split))
    for a, b in zip(f_t, jut.split_constants(pj, jnp.int32(split))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
