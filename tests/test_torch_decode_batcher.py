"""The port's real-model batchers (DecodeBatcher, EdgeBatcher, slot_update,
slot_where) on the reduced recurrentgemma-9b and qwen1.5-0.5b, on the CPU.

  * the JAX package's tests/test_online_loop.py batching cases on the port:
    stacked masked-slot edge serving against per-request sequential serving
    at three cuts, and the decode slots against each request's own prefill
    and decode (a frozen slot resumes exactly; a slot vacated mid-decode
    re-admits a new request without perturbing its siblings), within the
    reference's bound 0.05 * max(1, max |logits|);
  * the same admissions and masked steps through the JAX package's
    DecodeBatcher on the reference's Model.init parameters carried across
    (convert.model_params_from_numpy): every logits row within the same
    bound. Both packages write every slot's new K/V at slot 0's ring index
    (uniform across the batch, models/attention.py), so a slot admitted
    mid-decode is held to the reference's batcher on that case as well;
  * slot_update / slot_where write and select exactly the slot axis of the
    port's cache layout (stage leaves (L, B, ...), "pos" (B,));
  * the MoE and xLSTM families (reduced deepseek-moe-16b and xlstm-125m):
    both packages' DecodeBatcher on the reference's parameters, every
    logits row within the same bound, with the port's caches exported and
    imported into a fresh batcher mid-run (the steps after it bit-equal to
    an uninterrupted batcher's), and slot_update / slot_where over the
    mLSTM C leaf (L, B, H, hd, hd) and the sLSTM stabilizer m, which starts
    at -1e30.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.online import DecodeBatcher, EdgeBatcher, slot_update, slot_where  # noqa: E402
from repro_torch.runtime import make_split_serve  # noqa: E402

ARCHS = ["recurrentgemma-9b", "qwen1.5-0.5b"]
B, S_LEN = 3, 8


def _bound(want) -> float:
    return 0.05 * max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


def _assert_near(got, want, what):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err < _bound(want), (what, err, _bound(want))


def _tokens(cfg, seed, n=B):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (n, S_LEN), generator=g, dtype=torch.int32)


def _model(name):
    cfg = configs.get(name).reduced()
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def _reference(model, toks, n_steps, max_len):
    """Per-request prefill + greedy decode: the logits of each step."""
    logits, caches = model.prefill({"tokens": toks}, max_len)
    steps = [logits[0]]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for _ in range(n_steps):
        logits, caches = model.decode_step(caches, tok)
        steps.append(logits[0])
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return steps


@pytest.mark.parametrize("name", ARCHS)
def test_masked_batching_matches_sequential_serving(name):
    model = _model(name)
    cfg = model.cfg
    toks = _tokens(cfg, 1)
    for cut in (0, cfg.n_layers // 2, cfg.n_layers):
        progs = make_split_serve(model, cut)
        acts = [progs.device_fn(toks[i:i + 1]) for i in range(B)]
        eb = EdgeBatcher(B, S_LEN, cfg.d_model, dtype=acts[0].dtype, device="cpu")
        buf = eb.buf
        for i, a in enumerate(acts):
            buf = eb.write(buf, i, a)
        batched = eb.run(progs.edge_fn, buf)
        seq = torch.cat([progs.edge_fn(a) for a in acts], 0)
        _assert_near(batched, seq, (name, cut))
    refs = [_reference(model, toks[i:i + 1], 2, S_LEN + 4) for i in range(B)]
    db = DecodeBatcher(model, None, capacity=B, max_len=S_LEN + 4)
    for i in range(B):
        _assert_near(db.admit(i, toks[i:i + 1]), refs[i][0], (name, "prefill", i))
    tok1 = torch.stack([torch.argmax(r[0]) for r in refs])[:, None].to(torch.int32)
    lg1 = db.step(tok1, torch.tensor([True, True, True]))
    for i in range(B):
        _assert_near(lg1[i], refs[i][1], (name, "step 1", i))
    # slot 1 sits out an epoch; its frozen caches resume the same next step
    tok2 = torch.stack([torch.argmax(r[1]) for r in refs])[:, None].to(torch.int32)
    frozen = _slot(db.caches, 1)
    lg2 = db.step(tok2, torch.tensor([True, False, True]))
    assert all(torch.equal(a, b) for a, b in zip(frozen, _slot(db.caches, 1)))
    for i in (0, 2):
        _assert_near(lg2[i], refs[i][2], (name, "step 2", i))
    lg3 = db.step(tok2, torch.tensor([False, True, False]))
    _assert_near(lg3[1], refs[1][2], (name, "step 3", 1))
    with pytest.raises(ValueError, match="params=None"):
        DecodeBatcher(model, {}, capacity=1, max_len=4)


def _slot(caches, i):
    """Copies of every leaf's slot i, in the port's cache layout (copies:
    the batcher's steps write its live caches in place)."""
    out = [caches["pos"][i].clone()]
    for st in caches["stages"]:
        for leaf in next(iter(st.values())).values():
            out.append(leaf[:, i].clone())
    return out


def test_mid_decode_dropout_frees_slot_without_perturbing_siblings():
    """tests/test_online_loop.py's departure case on the port (reduced
    recurrentgemma-9b): two epochs with slot 1 masked off leave its siblings
    on their references; slot 1 then re-admits a new request whose prefill
    and first step match its own reference."""
    model = _model("recurrentgemma-9b")
    cfg = model.cfg
    toks, new_toks = _tokens(cfg, 1), _tokens(cfg, 2, 1)
    refs = [_reference(model, toks[i:i + 1], 3, S_LEN + 6) for i in range(B)]
    new_ref = _reference(model, new_toks, 1, S_LEN + 6)
    db = DecodeBatcher(model, None, capacity=B, max_len=S_LEN + 6)
    for i in range(B):
        db.admit(i, toks[i:i + 1])

    def greedy(k):
        return torch.stack([torch.argmax(r[k]) for r in refs])[:, None].to(torch.int32)
    lg1 = db.step(greedy(0), torch.tensor([True, True, True]))
    for i in range(B):
        _assert_near(lg1[i], refs[i][1], ("step 1", i))
    for k in (1, 2):
        lg = db.step(greedy(k), torch.tensor([True, False, True]))
        for i in (0, 2):
            _assert_near(lg[i], refs[i][k + 1], (k, i))
    _assert_near(db.admit(1, new_toks), new_ref[0], "re-admitted prefill")
    tok_new = torch.zeros((B, 1), dtype=torch.int32)
    tok_new[1, 0] = torch.argmax(new_ref[0])
    lg_new = db.step(tok_new, torch.tensor([False, True, False]))
    _assert_near(lg_new[1], new_ref[1], "re-admitted step")


def test_slot_update_and_where_touch_only_the_slot_axis():
    model = _model("recurrentgemma-9b")
    full = model.make_caches(4, 16)
    _, one = model.prefill({"tokens": _tokens(model.cfg, 3, 1)}, 16)
    upd = slot_update(full, 2, one)
    for i in range(4):
        got, before = _slot(upd, i), _slot(full, i)
        want = _slot(one, 0) if i == 2 else before
        assert all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, want)), i
    mask = torch.tensor([True, False, True, False])
    sel = slot_where(mask, upd, full)
    for i in range(4):
        src = upd if mask[i] else full
        assert all(torch.equal(a, b) for a, b in zip(_slot(sel, i), _slot(src, i)))


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro.online import DecodeBatcher as JDecodeBatcher
    return dict(jax=jax, configs=jconfigs, Model=JModel, DecodeBatcher=JDecodeBatcher)


def test_decode_batcher_matches_reference_batcher(jx):
    """Both packages' DecodeBatcher on the reference's parameters (reduced
    recurrentgemma-9b): three admissions, masked steps with a departure,
    a re-admission mid-decode (its length differs from slot 0's, so both
    write its K/V at slot 0's ring index) and a step after it."""
    jax, jnp = jx["jax"], jx["jax"].numpy
    jcfg = jx["configs"].get("recurrentgemma-9b").reduced()
    jm = jx["Model"](jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    model = convert.model_params_from_numpy(
        Model(configs.get("recurrentgemma-9b").reduced(), device="cpu"),
        jax.tree.map(np.asarray, params))
    toks, new_toks = _tokens(model.cfg, 1), _tokens(model.cfg, 2, 1)
    jdb = jx["DecodeBatcher"](jm, params, capacity=B, max_len=S_LEN + 6)
    db = DecodeBatcher(model, None, capacity=B, max_len=S_LEN + 6)
    for i in range(B):
        _assert_near(db.admit(i, toks[i:i + 1]), jdb.admit(i, jnp.asarray(toks[i:i + 1].numpy())),
                     ("admit", i))
    rng = np.random.default_rng(0)
    for k, mask in enumerate(([True] * 3, [True, False, True], [True, False, True])):
        tok = rng.integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32)
        got = db.step(torch.from_numpy(tok), torch.tensor(mask))
        want = jdb.step(jnp.asarray(tok), jnp.asarray(mask))
        for i in np.flatnonzero(mask):
            _assert_near(got[i], want[i], ("step", k, i))
    _assert_near(db.admit(1, new_toks), jdb.admit(1, jnp.asarray(new_toks.numpy())), "re-admit")
    for mask in ([False, True, False], [True, True, True]):
        tok = rng.integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32)
        got = db.step(torch.from_numpy(tok), torch.tensor(mask))
        want = jdb.step(jnp.asarray(tok), jnp.asarray(mask))
        for i in np.flatnonzero(mask):
            _assert_near(got[i], want[i], ("after re-admit", mask, i))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "xlstm-125m"])
def test_decode_batcher_of_the_new_families_matches_the_reference(jx, name):
    jax, jnp = jx["jax"], jx["jax"].numpy
    jm = jx["Model"](jx["configs"].get(name).reduced(), remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    model = convert.model_params_from_numpy(Model(configs.get(name).reduced(), device="cpu"),
                                            jax.tree.map(np.asarray, params))
    toks = _tokens(model.cfg, 1)
    jdb = jx["DecodeBatcher"](jm, params, capacity=B, max_len=S_LEN + 8)
    db = DecodeBatcher(model, None, capacity=B, max_len=S_LEN + 8)
    for i in range(B):
        _assert_near(db.admit(i, toks[i:i + 1]), jdb.admit(i, jnp.asarray(toks[i:i + 1].numpy())),
                     (name, "admit", i))
    rng = np.random.default_rng(0)
    masks = [[True] * 3, [True, False, True], [True, True, True], [False, True, True]]
    steps = [(rng.integers(0, model.cfg.vocab_size, (B, 1)).astype(np.int32), m) for m in masks]
    resumed = None
    for k, (tok, mask) in enumerate(steps):
        if k == 2:      # a snapshot's batcher leg, into a fresh batcher
            resumed = DecodeBatcher(model, None, capacity=B, max_len=S_LEN + 8)
            resumed.import_caches(db.export_caches())
        got = db.step(torch.from_numpy(tok), torch.tensor(mask))
        want = jdb.step(jnp.asarray(tok), jnp.asarray(mask))
        for i in np.flatnonzero(mask):
            _assert_near(got[i], want[i], (name, "step", k, i))
        if resumed is not None:
            assert torch.equal(resumed.step(torch.from_numpy(tok), torch.tensor(mask)), got)
    assert all(torch.equal(a, b) for a, b in zip(_slot(resumed.caches, 0), _slot(db.caches, 0)))


def test_slot_update_and_where_over_xlstm_caches():
    model = _model("xlstm-125m")
    cfg = model.cfg
    full = model.make_caches(4, 16)
    assert full["stages"][0]["mlstm"]["C"].shape == (1, 4, cfg.n_heads, cfg.hd, cfg.hd)
    assert bool((full["stages"][1]["slstm"]["m"] == -1e30).all())
    _, one = model.prefill({"tokens": _tokens(cfg, 3, 1)}, 16)
    upd = slot_update(full, 2, one)
    m = upd["stages"][1]["slstm"]["m"]
    assert bool((m[:, [0, 1, 3]] == -1e30).all()) and bool((m[:, 2] > -1e30).all())
    for i in range(4):
        want = _slot(one, 0) if i == 2 else _slot(full, i)
        assert all(torch.equal(a, b) for a, b in zip(_slot(upd, i), want)), i
    mask = torch.tensor([False, False, True, True])
    sel = slot_where(mask, upd, full)
    for i in range(4):
        src = upd if mask[i] else full
        assert all(torch.equal(a, b) for a, b in zip(_slot(sel, i), _slot(src, i)))
