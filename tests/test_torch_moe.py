"""The port's MoE layer and MoE models against the JAX package's.

Reduced deepseek-moe-16b (a dense first layer, then MoE with a shared
expert, top-2 of 8) and reduced llama4-scout-17b-a16e (MoE in every layer,
top-1 of 8), with the JAX parameters carried over by
convert.model_params_from_numpy.

  * moe_apply for both impls on one bf16 input: each row within 2e-2 of its
    largest magnitude (the model tolerance of test_torch_models.py), the
    router's choices equal, the aux loss within 1e-6;
  * the router on grid-valued inputs whose bf16 product is exact, with tied
    logits built in (duplicated router columns): indices equal (lower index
    first on ties, jax.lax.top_k's order), gates within 1e-6; _top_k against
    jax.lax.top_k on arrays full of ties;
  * at capacity_factor 0.5, where half the slots drop, the same slots drop
    in both packages: each package's drop mask read off its own
    _experts_sorted with one gate column kept at a time (a dropped slot
    contributes exactly 0), and the port's dispatch() mask beside them;
  * whole-model logits in float32 (COMPUTE_DTYPE monkeypatched in both
    packages) within F32_TOL of each position's largest |logit|, aux loss
    within 1e-6 of the reference's;
  * whole-model logits in bf16 within the JAX package's own bound for two
    paths of one bf16 MoE model, 0.05 * max(1, max |logits|), three times
    that for top-1 routing (tests/test_models.py's decode test): a bf16 ulp
    of the residual stream flips a router choice at a near-tie, and every
    later position of that token moves (ROADMAP.md section 3; the float32
    check above shows the math is the same);
  * prefill and decode against the reference's prefill and decode, with
    capacity 16 in both (nothing drops), within the same bound;
  * the planner's profiles of both archs equal the reference's (its
    moe_every reading included).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import F32_TOL, _model_check  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import Model, layers, moe  # noqa: E402

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]
B, S = 2, 96


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import profiles as jprofiles
    from repro.models import Model as JModel
    from repro.models import moe as jmoe
    from repro.models.layers import init_params
    return dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel, moe=jmoe,
                init_params=init_params, profiles=jprofiles)


@pytest.fixture(scope="module")
def layer_params(jx):
    """Per arch: (reduced cfg, the reference's MoE layer params, the port's
    copy in its storage dtypes)."""
    out = {}
    for name in ARCHS:
        jcfg = jx["configs"].get(name).reduced()
        p = jx["init_params"](jx["moe"].moe_defs(jcfg), jx["jax"].random.PRNGKey(0))
        cfg = configs.get(name).reduced()
        pt = {k: torch.from_numpy(np.array(p[k])).to(d.dtype)
              for k, d in moe.moe_defs(cfg).items()}
        out[name] = (cfg, p, pt)
    return out


def _x(cfg, seed, n=B * S):
    x = np.random.default_rng(seed).standard_normal((1, n, cfg.d_model)).astype(np.float32)
    return x, torch.from_numpy(x).to(torch.bfloat16)


def _rows_close(got, want, what, tol=2e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    row = np.abs(want).max(axis=-1, keepdims=True)
    worst = float((np.abs(got - want) / np.maximum(row, 1e-30)).max())
    assert worst <= tol, f"{what}: worst {worst:.3e} of the row's max > {tol}"


@pytest.mark.parametrize("impl", ["sorted", "dense"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_the_reference(jx, layer_params, name, impl):
    cfg, p, pt = layer_params[name]
    x, xb = _x(cfg, 0)
    xj = jx["jnp"].asarray(x, jx["jnp"].bfloat16)
    y, aux = moe.moe_apply(pt, xb, cfg, impl=impl)
    yj, auxj = jx["moe"].moe_apply(p, xj, cfg, impl=impl)
    _rows_close(y.float()[0], yj[0], f"{name} {impl}")
    assert abs(float(aux) - float(auxj)) <= 1e-6
    _, idx, _ = moe._router(pt, xb[0], cfg)
    _, idxj, _ = jx["moe"]._router(p, xj[0], cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idxj))


def test_top_k_puts_the_lower_index_first_on_ties(jx):
    rng = np.random.default_rng(0)
    for e, k in ((8, 1), (8, 2), (64, 6)):
        probs = rng.integers(0, 4, (256, e)).astype(np.float32)   # ties everywhere
        vals, idx = moe._top_k(torch.from_numpy(probs), k)
        jvals, jidx = jx["jax"].lax.top_k(jx["jnp"].asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("name", ARCHS)
def test_router_matches_the_reference_on_built_ties(jx, layer_params, name):
    """x in {-1, 0, 1}, router weights on a 2^-6 grid under 4/d: every
    partial sum is exact in bf16, so both packages see the same logits;
    columns 1, 2 and 5 of the router are copies of column 0 and column 4 of
    column 3, so most tokens tie at the top-k boundary."""
    cfg, p, pt = layer_params[name]
    jnp = jx["jnp"]
    rng = np.random.default_rng(1)
    x = rng.integers(-1, 2, (B * S, cfg.d_model)).astype(np.float32)
    r = rng.integers(-2, 3, (cfg.d_model, cfg.n_experts)).astype(np.float32) / 64
    r[:, [1, 2, 5]] = r[:, [0]]
    r[:, 4] = r[:, 3]
    gates, idx, aux = moe._router(dict(pt, router=torch.from_numpy(r).to(torch.bfloat16)),
                                  torch.from_numpy(x).to(torch.bfloat16), cfg)
    jgates, jidx, jaux = jx["moe"]._router(dict(p, router=jnp.asarray(r)),
                                           jnp.asarray(x, jnp.bfloat16), cfg)
    logits = x @ r
    top = np.sort(logits, axis=1)[:, ::-1]
    k = cfg.top_k
    tied = int(np.sum(top[:, k - 1] == top[:, k]))
    assert tied > B * S // 4, tied          # the case is really built of ties
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=0, atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def _drop_mask(experts_sorted, p, xt, gates, idx, cfg, cf, to_np):
    """(N, k) bool: the slots an _experts_sorted drops, read off its output
    with one gate column kept at a time (a dropped slot adds exactly 0)."""
    masks = []
    for j in range(cfg.top_k):
        keep_col = np.zeros(cfg.top_k, np.float32)
        keep_col[j] = 1.0
        g = gates * (torch.from_numpy(keep_col) if isinstance(gates, torch.Tensor)
                     else keep_col)
        y = to_np(experts_sorted(p, xt, g, idx, cfg, cf))
        masks.append(np.all(y == 0, axis=-1))
    return np.stack(masks, axis=1)


@pytest.mark.parametrize("name", ARCHS)
def test_the_same_slots_drop_at_capacity_half(jx, layer_params, name):
    cfg, p, pt = layer_params[name]
    jnp = jx["jnp"]
    x, xb = _x(cfg, 2)
    xj = jnp.asarray(x[0], jnp.bfloat16)
    gates, idx, _ = moe._router(pt, xb[0], cfg)
    jgates, jidx, _ = jx["moe"]._router(p, xj, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    cf = 0.5
    got = _drop_mask(moe._experts_sorted, pt, xb[0], gates, idx, cfg, cf,
                     lambda y: y.float().numpy())
    want = _drop_mask(jx["moe"]._experts_sorted, p, xj, jgates, jidx, cfg, cf,
                      lambda y: np.asarray(y, np.float32))
    order, _, keep = moe.dispatch(idx, cfg.n_experts, moe.capacity(B * S, cfg, cf))
    dropped = torch.zeros(idx.numel(), dtype=torch.bool)
    dropped[order] = ~keep
    n, k = idx.shape
    assert 0.3 * n * k < want.sum() < 0.7 * n * k      # about half drop
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dropped.view(n, k).numpy(), want)
    with moe.drop_log() as log:
        y = moe._experts_sorted(pt, xb[0], gates, idx, cfg, cf)
    assert [int(c) for c in log] == [int(want.sum())]
    _rows_close(y.float(), jx["moe"]._experts_sorted(p, xj, jgates, jidx, cfg, cf),
                f"{name} sorted at capacity {cf}")


def test_sorted_matches_dense_and_repeats_to_the_bit(layer_params):
    """tests/test_models.py's sorted == dense case on the port (capacity
    E, nothing drops; atol 0.03, rtol 0.05), and two sorted calls equal."""
    cfg, _, pt = layer_params["deepseek-moe-16b"]
    xb = 0.1 * _x(cfg, 3, 16)[1]
    y_s, aux_s = moe.moe_apply(pt, xb, cfg, impl="sorted", capacity_factor=cfg.n_experts)
    y_d, aux_d = moe.moe_apply(pt, xb, cfg, impl="dense")
    np.testing.assert_allclose(y_s.float().numpy(), y_d.float().numpy(), atol=0.03, rtol=0.05)
    assert abs(float(aux_s) - float(aux_d)) <= 1e-5 * abs(float(aux_d))
    assert torch.equal(moe.moe_apply(pt, xb, cfg)[0], moe.moe_apply(pt, xb, cfg)[0])


@pytest.fixture(scope="module")
def pairs(jx):
    """Per arch: (the JAX model at capacity 16, its params, their numpy
    tree)."""
    out = {}
    for name in ARCHS:
        jm = jx["Model"](jx["configs"].get(name).reduced(), remat=False, moe_capacity=16.0)
        params = jm.init(jx["jax"].random.PRNGKey(0))
        out[name] = (jm, params, jx["jax"].tree.map(np.asarray, params))
    return out


def _port(tree, name, dtype_patch=False):
    model = Model(configs.get(name).reduced(), device="cpu", moe_capacity=16.0)
    return convert.model_params_from_numpy(model.float() if dtype_patch else model, tree)


def _bound(cfg, want) -> float:
    """The JAX package's bound for two paths of one bf16 model."""
    return 0.05 * max(1.0, float(np.abs(np.asarray(want, np.float32)).max())) * (
        3.0 if cfg.top_k == 1 else 1.0)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_in_float32_matches_the_reference(jx, pairs, name, monkeypatch):
    import repro.models.attention
    import repro.models.layers
    import repro.models.moe

    import repro_torch.models.attention
    for mod in (repro.models.attention, repro.models.layers, repro.models.moe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx["jnp"].float32)
    for mod in (repro_torch.models.attention, layers, moe):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    jm, params, tree = pairs[name]
    model = _port(tree, name, dtype_patch=True)
    tokens = make_batch(3, 0, B, S, model.cfg.vocab_size, device="cpu")["tokens"]
    got, _, aux = model(tokens)
    want, _, jaux = jm.forward(params, jx["jnp"].asarray(tokens.numpy()))
    _model_check(got, want, f"{name} float32 forward logits", F32_TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_the_reference(jx, pairs, name):
    jm, params, tree = pairs[name]
    model = _port(tree, name)
    tokens = make_batch(3, 0, B, S, model.cfg.vocab_size, device="cpu")["tokens"]
    got, _, aux = model(tokens)
    want, _, _ = jm.forward(params, jx["jnp"].asarray(tokens.numpy()))
    assert got.shape == want.shape and bool(torch.isfinite(aux))
    err = float(np.abs(got.numpy() - np.asarray(want, np.float32)).max())
    assert err <= _bound(model.cfg, want), (name, err)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_after_prefill_matches_the_reference(jx, pairs, name):
    jm, params, tree = pairs[name]
    jnp = jx["jnp"]
    model = _port(tree, name)
    b, s, k = 2, 24, 4
    tokens = make_batch(1, 0, b, s, model.cfg.vocab_size, device="cpu")["tokens"]
    logits, caches = model.prefill({"tokens": tokens[:, :s - k]}, max_len=s + 8)
    jlogits, jcaches = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :s - k].numpy())},
                                  max_len=s + 8)
    errs = [float(np.abs(logits.numpy() - np.asarray(jlogits)).max())]
    bound = _bound(model.cfg, jlogits)
    for i in range(k):
        tok = tokens[:, s - k + i:s - k + i + 1]
        logits, caches = model.decode_step(caches, tok)
        jlogits, jcaches = jm.decode_step(params, jcaches, jnp.asarray(tok.numpy()))
        errs.append(float(np.abs(logits.numpy() - np.asarray(jlogits)).max()))
    assert max(errs) <= bound, (name, errs, bound)
    assert int(caches["pos"][0]) == s


@pytest.mark.parametrize("name", ARCHS)
def test_profiles_equal_the_reference(jx, name):
    for cfg, jcfg in ((configs.get(name), jx["configs"].get(name)),
                      (configs.get(name).reduced(), jx["configs"].get(name).reduced())):
        got = profiles.from_arch_config(cfg, seq=512)
        want = jx["profiles"].from_arch_config(jcfg, seq=512)
        for f in ("fl", "w", "m_down"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
