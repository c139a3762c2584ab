"""The port's xLSTM blocks and model against the JAX package's.

Reduced xlstm-125m (mlstm, slstm, mlstm; d 128, 4 heads of 32), with the
JAX parameters carried over by convert.model_params_from_numpy.

  * _mlstm_chunk_scan over two chunks of 256, from zero and from a state,
    in float32: each output and state element within 1e-5 of its head's
    largest magnitude (its (S, hd) output, its (hd, hd) state), the same
    math summed in another order. An output row can sit far below the
    terms it sums (the normalizer divides both), so a row's own maximum is
    no scale for it: measured 7.3e-6 of the head's maximum, 1.4e-5 of the
    row's;
  * mlstm_apply's one-token decode step and slstm_apply from a state, with
    COMPUTE_DTYPE set to float32 in both packages, to the same 1e-5;
  * the gate weights (wi, wf, w_zifo, b_zifo, r_zifo) stored in float32;
  * a sequence that is not a multiple of the chunk (S = 300) raises the
    same AssertionError in both packages;
  * whole-model logits within the bf16 model tolerance of
    test_torch_models.py and within F32_TOL in float32; prefill and decode
    against the reference's prefill and decode within its bound 0.05 *
    max(1, max |logits|), and the reference's caches carried into the port
    (convert.caches_from_numpy) decoding the same next step;
  * the stage lists of both families equal the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import F32_TOL, MODEL_TOL, _model_check  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import Model, layers, stages_for, xlstm  # noqa: E402

NAME = "xlstm-125m"
XLSTM_TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro.models import xlstm as jxlstm
    from repro.models.layers import init_params
    return dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel, xlstm=jxlstm,
                init_params=init_params)


@pytest.fixture(scope="module")
def pair(jx):
    jm = jx["Model"](jx["configs"].get(NAME).reduced(), remat=False)
    params = jm.init(jx["jax"].random.PRNGKey(0))
    return jm, params, jx["jax"].tree.map(np.asarray, params)


def _close(got, want, what, tol=XLSTM_TOL, axes=(-1,)):
    """Each element within tol of the largest magnitude over ``axes``."""
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = np.maximum(np.abs(want).max(axis=axes, keepdims=True), 1e-30)
    worst = float((np.abs(got - want) / scale).max())
    assert worst <= tol, f"{what}: worst {worst:.3e} of the max over {axes} > {tol}"


def _f32(monkeypatch, jx):
    import repro.models.layers
    import repro.models.xlstm
    for mod in (repro.models.layers, repro.models.xlstm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx["jnp"].float32)
    for mod in (layers, xlstm):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunk_scan_over_two_chunks(jx, with_state):
    jnp = jx["jnp"]
    rng = np.random.default_rng(int(with_state))
    b, h, s, hd = 2, 2, 2 * xlstm.CHUNK, 16
    q, k, v = (rng.standard_normal((b, h, s, hd)).astype(np.float32) for _ in range(3))
    log_f = np.log(1 / (1 + np.exp(-(rng.standard_normal((b, h, s)) + 3.0)))).astype(np.float32)
    log_i = np.clip(rng.standard_normal((b, h, s)), -10, 5).astype(np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((b, h, hd, hd)).astype(np.float32),
                 np.abs(rng.standard_normal((b, h, hd))).astype(np.float32))
    t = [torch.from_numpy(a) for a in (q, k, v, log_f, log_i)]
    out, (C, n) = xlstm._mlstm_chunk_scan(
        *t, None if state is None else tuple(torch.from_numpy(a) for a in state))
    jout, (jC, jn) = jx["xlstm"]._mlstm_chunk_scan(
        *(jnp.asarray(a) for a in (q, k, v, log_f, log_i)),
        None if state is None else tuple(jnp.asarray(a) for a in state))
    head = (-2, -1)
    _close(out, jout, "chunk scan out", axes=head)
    _close(C, jC, "chunk scan C", axes=head)
    _close(n, jn, "chunk scan n")


def _block_params(jx, kind):
    cfg = configs.get(NAME).reduced()
    defs = (xlstm.mlstm_defs if kind == "mlstm" else xlstm.slstm_defs)(cfg)
    jdefs = getattr(jx["xlstm"], f"{kind}_defs")(jx["configs"].get(NAME).reduced())
    p = jx["init_params"](jdefs, jx["jax"].random.PRNGKey(3))
    p = dict(p, **{k: 0.1 + 0.05 * v for k, v in p.items() if k == "b_zifo"})
    return cfg, p, {k: torch.from_numpy(np.array(p[k])) for k in defs}


def test_gate_weights_stay_float32():
    cfg = configs.get(NAME).reduced()
    m, s = xlstm.mlstm_defs(cfg), xlstm.slstm_defs(cfg)
    assert {k for k, d in {**m, **s}.items() if d.dtype == torch.float32} == \
        {"wi", "wf", "w_zifo", "b_zifo", "r_zifo"}
    assert s["r_zifo"].scale == 0.05
    model = Model(cfg, device="cpu")
    assert model.stage_layers[1][0].p.slstm.r_zifo.dtype == torch.float32


def test_mlstm_decode_step_from_a_state(jx, monkeypatch):
    _f32(monkeypatch, jx)
    jnp = jx["jnp"]
    cfg, p, pt = _block_params(jx, "mlstm")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    C = rng.standard_normal((2, cfg.n_heads, cfg.hd, cfg.hd)).astype(np.float32)
    n = np.abs(rng.standard_normal((2, cfg.n_heads, cfg.hd))).astype(np.float32)
    out, st = xlstm.mlstm_apply(pt, torch.from_numpy(x), cfg,
                                {"C": torch.from_numpy(C), "n": torch.from_numpy(n)})
    jout, jst = jx["xlstm"].mlstm_apply(p, jnp.asarray(x), jx["configs"].get(NAME).reduced(),
                                        {"C": jnp.asarray(C), "n": jnp.asarray(n)})
    _close(out, jout, "mlstm decode out")
    _close(st["C"], jst["C"], "mlstm decode C")
    _close(st["n"], jst["n"], "mlstm decode n")


def test_slstm_from_a_state(jx, monkeypatch):
    _f32(monkeypatch, jx)
    jnp = jx["jnp"]
    cfg, p, pt = _block_params(jx, "slstm")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    shape = (2, cfg.n_heads, cfg.hd)
    st = {k: rng.standard_normal(shape).astype(np.float32) for k in ("c", "n", "h")}
    st["m"] = rng.uniform(-2, 0, shape).astype(np.float32)
    out, new = xlstm.slstm_apply(pt, torch.from_numpy(x), cfg,
                                 {k: torch.from_numpy(v) for k, v in st.items()})
    jout, jnew = jx["xlstm"].slstm_apply(p, jnp.asarray(x), jx["configs"].get(NAME).reduced(),
                                         {k: jnp.asarray(v) for k, v in st.items()})
    _close(out, jout, "slstm out")
    for k in ("c", "n", "h", "m"):
        _close(new[k], jnew[k], f"slstm state {k}")


def test_a_sequence_off_the_chunk_raises_in_both(jx, pair):
    jm, params, tree = pair
    model = convert.model_params_from_numpy(Model(configs.get(NAME).reduced(), device="cpu"),
                                            tree)
    tokens = make_batch(0, 0, 1, 300, model.cfg.vocab_size, device="cpu")["tokens"]
    with pytest.raises(AssertionError, match="seq 300 must divide chunk 256"):
        model(tokens)
    with pytest.raises(AssertionError, match="seq 300 must divide chunk 256"):
        jm.forward(params, jx["jnp"].asarray(tokens.numpy()))


def test_forward_logits_match_the_reference(jx, pair):
    jm, params, tree = pair
    model = convert.model_params_from_numpy(Model(configs.get(NAME).reduced(), device="cpu"),
                                            tree)
    tokens = make_batch(3, 0, 2, 512, model.cfg.vocab_size, device="cpu")["tokens"]
    got, _, aux = model(tokens)
    want, _, _ = jm.forward(params, jx["jnp"].asarray(tokens.numpy()))
    _model_check(got, want, "xlstm forward logits", MODEL_TOL)
    assert float(aux) == 0.0


def test_forward_in_float32_matches_the_reference(jx, pair, monkeypatch):
    _f32(monkeypatch, jx)
    jm, params, tree = pair
    model = convert.model_params_from_numpy(
        Model(configs.get(NAME).reduced(), device="cpu").float(), tree)
    tokens = make_batch(3, 0, 2, 512, model.cfg.vocab_size, device="cpu")["tokens"]
    got, _, _ = model(tokens)
    want, _, _ = jm.forward(params, jx["jnp"].asarray(tokens.numpy()))
    _model_check(got, want, "xlstm float32 forward logits", F32_TOL)


def test_decode_after_prefill_matches_the_reference(jx, pair):
    jm, params, tree = pair
    jnp = jx["jnp"]
    model = convert.model_params_from_numpy(Model(configs.get(NAME).reduced(), device="cpu"),
                                            tree)
    b, s, k = 2, 260, 4
    tokens = make_batch(1, 0, b, s, model.cfg.vocab_size, device="cpu")["tokens"]
    logits, caches = model.prefill({"tokens": tokens[:, :s - k]}, max_len=s + 8)
    jlogits, jcaches = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :s - k].numpy())},
                                  max_len=s + 8)
    bound = 0.05 * max(1.0, float(np.abs(np.asarray(jlogits)).max()))
    errs = [float(np.abs(logits.numpy() - np.asarray(jlogits)).max())]
    # the reference's caches in the port: the same next step, to float32
    carried = convert.caches_from_numpy(jx["jax"].tree.map(np.asarray, jcaches), like=caches)
    tok = tokens[:, s - k:s - k + 1]
    got_c, _ = model.decode_step(carried, tok)
    want_c, _ = jm.decode_step(params, jcaches, jnp.asarray(tok.numpy()))
    _model_check(got_c, want_c, "decode from the reference's caches", MODEL_TOL)
    for i in range(k):
        tok = tokens[:, s - k + i:s - k + i + 1]
        logits, caches = model.decode_step(caches, tok)
        jlogits, jcaches = jm.decode_step(params, jcaches, jnp.asarray(tok.numpy()))
        errs.append(float(np.abs(logits.numpy() - np.asarray(jlogits)).max()))
    assert max(errs) <= bound, (errs, bound)
    assert int(caches["pos"][0]) == s
    assert float(caches["stages"][1]["slstm"]["m"].max()) > -1e30   # the state moved


def test_stage_lists_equal_the_reference(jx):
    for name in ("xlstm-125m", "deepseek-moe-16b", "llama4-scout-17b-a16e"):
        for cfg, jcfg in ((configs.get(name), jx["configs"].get(name)),
                          (configs.get(name).reduced(), jx["configs"].get(name).reduced())):
            got = [dataclasses.asdict(s) for s in stages_for(cfg)]
            want = [dataclasses.asdict(s) for s in jx["Model"](jcfg).stages]
            assert got == want, name
    xl = stages_for(configs.get(NAME))
    assert [s.kind for s in xl] == ["mlstm", "slstm"] * 6
    assert [s.cache for s in xl] == [s.kind for s in xl]
