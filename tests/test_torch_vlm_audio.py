"""The vision and audio families of the port against the JAX package.

Reduced llama-3.2-vision-11b (vlm: attn, cross, attn, cross; G = 4) and
whisper-small (audio: 2 enc + 2 dec blocks, LayerNorm), d 128, 4 heads, hd
32, 16 frontend tokens, with the JAX Model.init parameters carried over by
convert.model_params_from_numpy. The reference initialises every xgate to
zero, so a cross block adds exactly nothing; both packages get the same
edited tree: xgate 0.5 and -0.7 by layer, and random LayerNorm weights and
biases (1 + 0.1 N(0, 1) and 0.1 N(0, 1)), so the cross path and the biases
are what is compared.

Tolerances, as tests/test_torch_models.py states them:
  * bf16 blocks and logits within 2e-2 of each position's largest
    magnitude (MODEL_TOL) and within the JAX package's own bound for two
    paths of one bf16 model, 0.05 * max(1, max |logits|);
  * the whole model with COMPUTE_DTYPE set to float32 in both packages
    within 1e-5 of each position's largest |logit| (F32_TOL);
  * the sinusoid table in bf16 at positions 0..1499 within one bf16 ulp of
    the value plus what the float32 angle may move: XLA's float32 exp on
    the CPU is not correctly rounded, so a frequency may differ by one ulp
    (ROADMAP.md section 3), which moves the angle by pos * ulp(freq) and
    its rounding by an ulp of the angle; the two rounded values then sit at
    most one bf16 ulp further apart.

What the reference does and the port copies (ROADMAP.md section 3): split
serving of whisper runs the encoder stage over the token embeddings and
cross-attends to the raw frontend; a cross attention given no frontend
attends over its own input, rotated and unmasked; a prefill with no
frontend reads the zero "frontend" / "enc_out" of make_caches."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import F32_TOL, MODEL_TOL, _model_check  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import Model, attention, layers, stages_for  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.blocks import block_apply  # noqa: E402
from repro_torch.online import DecodeBatcher  # noqa: E402
from repro_torch.runtime.serve import make_split_serve  # noqa: E402

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-small"
ARCHS = [VLM, AUDIO]
B, S, SF = 2, 40, 16      # requests, tokens, frontend tokens (the reduced configs')
GATES = (0.5, -0.7)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.data import make_batch as jmake_batch
    from repro.models import Model as JModel
    from repro.models import attention as jattention
    from repro.models import blocks as jblocks
    from repro.models import model as jmodel
    from repro.online import DecodeBatcher as JDecodeBatcher
    from repro.runtime import serve as jserve
    return dict(jax=jax, jnp=jnp, configs=jconfigs, make_batch=jmake_batch, Model=JModel,
                attention=jattention, blocks=jblocks, model=jmodel,
                DecodeBatcher=JDecodeBatcher, serve=jserve)


def _edited_tree(jx, jm, family):
    """The reference's Model.init(PRNGKey(0)) as numpy, xgate set to GATES by
    layer and the LayerNorm weights and biases drawn at random."""
    jax = jx["jax"]
    rng = np.random.default_rng(1)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))

    def edit(path, a):
        key = path[-1].key
        if key == "xgate":
            return np.asarray(GATES[:a.shape[0]], np.float32).reshape(a.shape)
        if key.endswith("_b"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if key.endswith("_w") and family == "audio":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.array(a)
    return jax.tree_util.tree_map_with_path(edit, tree)


_PAIRS: dict = {}


def _pair(jx, name):
    """(JAX model, its params, the numpy tree, port model on the CPU with
    them), built once a module."""
    if name not in _PAIRS:
        jm = jx["Model"](jx["configs"].get(name).reduced(), remat=False)
        tree = _edited_tree(jx, jm, jm.cfg.family)
        params = jx["jax"].tree.map(jx["jnp"].asarray, tree)
        model = convert.model_params_from_numpy(
            Model(configs.get(name).reduced(), device="cpu"), tree)
        _PAIRS[name] = (jm, params, tree, model)
    return _PAIRS[name]


def _batch(seed=3, s=S):
    return make_batch(seed, 0, B, s, 512, frontend_shape=(SF, 128), device="cpu")


def _j(jx, t):
    """A port tensor as a JAX array of the same dtype (bf16 through float32,
    exactly)."""
    jnp = jx["jnp"]
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("sq", [24, 3])
def test_cross_attention_matches_the_reference(jx, sq):
    """attn_apply with kv_src at Sq = 24 > Sk = 16 (through the kernel's
    twin) and Sq = 3 <= 8 (the single-pass path), G = 4, no rotation, no
    mask."""
    jm, params, _, model = _pair(jx, VLM)
    stage = 1
    assert model.stages[stage].kind == "cross"
    p = model.stage_layers[stage][0].p.tree()["xattn"]
    jp = jx["jax"].tree.map(lambda a: a[0], params["stages"][stage]["xattn"])
    rng = np.random.default_rng(sq)
    x, src = _bf16(rng, (B, sq, 128)), _bf16(rng, (B, SF, 128))
    pos = torch.arange(sq, dtype=torch.int32)[None].expand(B, sq)
    got, cache = attention.attn_apply(p, x, model.cfg, pos, kv_src=src, causal=False)
    want, _ = jx["attention"].attn_apply(jp, _j(jx, x), jm.cfg, _j(jx, pos.contiguous()),
                                         kv_src=_j(jx, src), causal=False)
    assert cache is None and got.dtype == torch.bfloat16
    _model_check(got.float(), want, f"cross attention Sq={sq}")


@pytest.mark.parametrize("name,stage", [(VLM, 1), (AUDIO, 0), (AUDIO, 1)])
def test_cross_enc_and_dec_blocks_match_the_reference(jx, name, stage):
    jm, params, _, model = _pair(jx, name)
    spec = model.stages[stage]
    rng = np.random.default_rng(stage)
    x, fr = _bf16(rng, (B, S, 128)), _bf16(rng, (B, SF, 128))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    got, _, _ = block_apply(model.cfg, spec, model.stage_layers[stage][0].p.tree(), x,
                            {"pos": pos, "frontend": fr})
    p0 = jx["jax"].tree.map(lambda a: a[0], params["stages"][stage])
    want, _, _ = jx["blocks"].block_apply(jm.cfg, jm.stages[stage], p0, _j(jx, x),
                                          {"pos": _j(jx, pos), "frontend": _j(jx, fr)})
    assert spec.kind == {(VLM, 1): "cross", (AUDIO, 0): "enc", (AUDIO, 1): "dec"}[name, stage]
    _model_check(got.float(), want, f"{spec.kind} block")


@pytest.mark.parametrize("d", [128, 768])
def test_sinusoid_to_1500(jx, d):
    jnp = jx["jnp"]
    pos = np.arange(1500, dtype=np.int32)[None]
    got = tmodel._sinusoid(torch.from_numpy(pos), d)
    want = np.asarray(jx["model"]._sinusoid(jnp.asarray(pos), d), np.float32)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1500, d)
    got = got.float().numpy()
    half = d // 2
    log_t = torch.log(torch.tensor(10000.0)) / half
    freq = torch.exp(-torch.arange(half, dtype=torch.float32) * log_t).numpy()
    ang = pos[0][:, None].astype(np.float32) * freq[None]
    ang_err = pos[0][:, None] * np.spacing(freq)[None] + np.spacing(ang)
    ang_err = np.concatenate([ang_err, ang_err], -1)[None]
    mag = np.maximum(np.abs(got), np.abs(want))
    bf16_ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    diff = np.abs(got - want)
    assert (diff <= ang_err + 1e-6 + bf16_ulp).all(), float((diff - ang_err - bf16_ulp).max())
    # most entries are the same bf16 number
    assert (diff == 0).mean() > 0.99


@pytest.mark.parametrize("name", ARCHS)
def test_forward_with_a_frontend_matches_the_reference(jx, name):
    jm, params, _, model = _pair(jx, name)
    batch = _batch()
    got, _, _ = model(batch["tokens"], batch["frontend"])
    want, _, _ = jm.forward(params, _j(jx, batch["tokens"]), _j(jx, batch["frontend"]))
    worst = _model_check(got, want, f"{name} forward logits")
    print(f"{name}: worst logit error {worst:.3e} of the position's max |logit| (bf16)")
    # the frontend is live: another frontend moves the logits
    other, _, _ = model(batch["tokens"], 2 * batch["frontend"])
    assert float((other - got).abs().max()) > 1e-3


@pytest.mark.parametrize("name", ARCHS)
def test_forward_in_float32_matches_the_reference(jx, name, monkeypatch):
    import repro.models.attention
    import repro.models.layers
    import repro.models.model
    for mod in (repro.models.attention, repro.models.layers, repro.models.model):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx["jnp"].float32)
    for mod in (attention, layers, tmodel):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    jm, params, tree, _ = _pair(jx, name)
    model = convert.model_params_from_numpy(
        Model(configs.get(name).reduced(), device="cpu").float(), tree)
    batch = _batch()
    fr = batch["frontend"].float()
    got, _, _ = model(batch["tokens"], fr)
    want, _, _ = jm.forward(params, _j(jx, batch["tokens"]), _j(jx, fr))
    worst = _model_check(got, want, f"{name} float32 forward logits", F32_TOL)
    print(f"{name}: worst logit error {worst:.3e} of the position's max |logit| (float32)")


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_the_forward_and_the_reference(jx, name):
    """Prefill of S - k tokens with the frontend, then k decode steps (the
    cross attention of each through the single-pass path over the cached
    frontend / enc_out): against the port's forward and the reference's
    prefill and decode within 0.05 * max(1, max |logits|); the reference's
    caches carried into the port (convert.caches_from_numpy: None stage
    entries, "enc_out" / "frontend") decode the same next step."""
    jm, params, _, model = _pair(jx, name)
    jnp = jx["jnp"]
    j_decode = jx["jax"].jit(jm.decode_step)
    batch = _batch(5)
    tokens, fr = batch["tokens"], batch["frontend"]
    k = 4
    full, _, _ = model(tokens, fr)
    bound = 0.05 * max(1.0, float(full.abs().max()))
    logits, caches = model.prefill({"tokens": tokens[:, :S - k], "frontend": fr}, max_len=S + 8)
    jlogits, jcaches = jm.prefill(params, {"tokens": _j(jx, tokens[:, :S - k]),
                                           "frontend": _j(jx, fr)}, max_len=S + 8)
    key = "enc_out" if name == AUDIO else "frontend"
    assert set(caches) == {"stages", "pos", key} == set(jcaches)
    assert [c is None for c in caches["stages"]] == [c is None for c in jcaches["stages"]]
    errs = [float((logits - full[:, S - k - 1]).abs().max())]
    errs_ref = [float(np.abs(logits.numpy() - np.asarray(jlogits)).max())]
    carried = convert.caches_from_numpy(jx["jax"].tree.map(np.asarray, jcaches), like=caches)
    tok = tokens[:, S - k:S - k + 1]
    got_c, _ = model.decode_step(carried, tok)
    want_c, _ = j_decode(params, jcaches, _j(jx, tok))
    _model_check(got_c, want_c, "decode from the reference's caches")
    for i in range(k):
        tok = tokens[:, S - k + i:S - k + i + 1]
        logits, caches = model.decode_step(caches, tok)
        jlogits, jcaches = j_decode(params, jcaches, jnp.asarray(tok.numpy()))
        errs.append(float((logits - full[:, S - k + i]).abs().max()))
        errs_ref.append(float(np.abs(logits.numpy() - np.asarray(jlogits)).max()))
    assert max(errs) < bound and max(errs_ref) < bound, (errs, errs_ref, bound)
    assert int(caches["pos"][0]) == S


@pytest.mark.parametrize("name", ARCHS)
def test_no_frontend_paths_follow_the_reference(jx, name):
    """With caches and no frontend (a prefill) both packages read the zero
    frontend / enc_out of make_caches; an audio forward with neither raises
    (a ValueError here, an AttributeError in the reference)."""
    jm, params, _, model = _pair(jx, name)
    tokens = _batch(6)["tokens"]
    logits, caches = model.prefill({"tokens": tokens}, max_len=S + 4)
    jlogits, _ = jm.prefill(params, {"tokens": _j(jx, tokens)}, max_len=S + 4)
    _model_check(logits, jlogits, f"{name} prefill without a frontend")
    key = "enc_out" if name == AUDIO else "frontend"
    assert caches[key].shape == (B, SF, 128) and not bool(caches[key].any())
    if name == AUDIO:
        with pytest.raises(ValueError, match="frontend"):
            model(tokens)
        with pytest.raises(AttributeError):
            jm.forward(params, _j(jx, tokens))


def test_make_batch_frontend_equals_the_reference(jx):
    for seed, step, b, s, shape in ((0, 0, 2, 24, (16, 128)), (3, 2, 3, 9, (5, 7))):
        got = make_batch(seed, step, b, s, 512, frontend_shape=shape, device="cpu")
        want = jx["make_batch"](seed, step, b, s, 512, frontend_shape=shape)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got["frontend"].dtype == torch.bfloat16
        assert got["frontend"].shape == (b, *shape)
        # bit-equal: the bf16 bit patterns
        np.testing.assert_array_equal(got["frontend"].view(torch.int16).numpy(),
                                      np.asarray(want["frontend"]).view(np.int16))
    plain = make_batch(0, 0, 2, 24, 512, device="cpu")
    assert "frontend" not in plain


def test_split_serve_with_a_frontend(jx):
    """vlm: every split point bit-equal to the forward, with the frontend
    and without one (the cross blocks then attend over their input, as the
    reference's). whisper: the reference's split, whose encoder stage runs
    over the token embeddings and whose decoder cross-attends to the raw
    frontend, against the reference's at a split inside the encoder and one
    inside the decoder, and bit-equal between all split points."""
    batch = _batch(7)
    tokens, fr = batch["tokens"], batch["frontend"]
    jm, params, _, model = _pair(jx, VLM)
    full, _, _ = model(tokens, fr)
    for s in range(len(model.stages) + 1):
        progs = make_split_serve(model, s)
        assert torch.equal(progs.edge_fn(progs.device_fn(tokens, fr), fr), full), s
    s = 1
    jprogs = jx["serve"].make_split_serve(jm, params, s)
    got = make_split_serve(model, s).edge_fn(make_split_serve(model, s).device_fn(tokens))
    _model_check(got, jprogs.edge_fn(jprogs.device_fn(_j(jx, tokens))), "vlm split, no frontend")

    jm, params, _, model = _pair(jx, AUDIO)
    n_blocks = sum(sp.n_layers for sp in model.stages)
    assert n_blocks == 4 > model.cfg.n_layers
    outs = []
    for s in range(n_blocks + 1):
        progs = make_split_serve(model, s)
        act = progs.device_fn(tokens, fr)
        outs.append(progs.edge_fn(act, fr))
        if s in (1, 3):
            jprogs = jx["serve"].make_split_serve(jm, params, s)
            j_act = jprogs.device_fn(_j(jx, tokens), _j(jx, fr))
            _model_check(act.float(), j_act, f"whisper device half s={s}")
            _model_check(outs[-1], jprogs.edge_fn(j_act, _j(jx, fr)), f"whisper split s={s}")
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="outside"):
        make_split_serve(model, n_blocks + 1)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_entry_point_runs_on_the_cpu(name, capsys):
    out = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu",
                             "--requests", "2", "--seq", "32", "--new-tokens", "2"])
    printed = capsys.readouterr().out
    assert "[plan] split layer s*=" in printed and "[serve] generated 2" in printed
    assert 0 <= out["split"] <= configs.get(name).reduced().n_layers
    assert out["new_tokens"].shape == (2, 2)
    assert 0 <= int(out["new_tokens"].min()) and int(out["new_tokens"].max()) < 512


def test_decode_batcher_over_the_vlm_matches_the_reference_batcher(jx):
    """Three admissions (each prefill cross-attends over the zero frontend
    of make_caches, in both packages), then the batchers' frontend set to
    a drawn one in both and masked steps that cross-attend to it."""
    jm, params, _, model = _pair(jx, VLM)
    jnp = jx["jnp"]
    n, max_len = 3, 20
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 512, (n, 8), generator=g, dtype=torch.int32)
    jdb = jx["DecodeBatcher"](jm, params, capacity=n, max_len=max_len)
    db = DecodeBatcher(model, None, capacity=n, max_len=max_len)
    bound = 0.05
    for i in range(n):
        got, want = db.admit(i, toks[i:i + 1]), jdb.admit(i, _j(jx, toks[i:i + 1]))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) < bound, ("admit", i)
    assert [c is None for c in db.caches["stages"]] == [False, True, False, True]
    fr = make_batch(2, 0, n, 1, 512, frontend_shape=(SF, 128), device="cpu")["frontend"]
    db.caches = dict(db.caches, frontend=fr)
    jdb.caches = dict(jdb.caches, frontend=_j(jx, fr))
    rng = np.random.default_rng(0)
    for k, mask in enumerate(([True] * 3, [True, False, True], [False, True, True])):
        tok = rng.integers(0, 512, (n, 1)).astype(np.int32)
        got = db.step(torch.from_numpy(tok), torch.tensor(mask))
        want = np.asarray(jdb.step(jnp.asarray(tok), jnp.asarray(mask)))
        bound = 0.05 * max(1.0, float(np.abs(want[np.asarray(mask)]).max()))
        for i in np.flatnonzero(mask):
            assert float(np.abs(got[i].numpy() - want[i]).max()) < bound, ("step", k, i)
    assert torch.equal(db.caches["frontend"], fr)


def test_caches_from_numpy_over_audio_caches(jx):
    jm, params, _, model = _pair(jx, AUDIO)
    like = model.make_caches(2, 12)
    jc = jx["jax"].tree.map(np.asarray, jm.make_caches(2, 12))
    got = convert.caches_from_numpy(jc, like)
    assert got["stages"][0] is None and got["enc_out"].dtype == torch.bfloat16
    assert got["enc_out"].shape == (2, SF, 128)
    kv = got["stages"][1]["kv"]
    assert kv["k"].shape == like["stages"][1]["kv"]["k"].shape and bool((kv["pos"] == -1).all())
    bad = dict(jc, stages=[jc["stages"][1], jc["stages"][1]])
    with pytest.raises(ValueError, match="cache entry"):
        convert.caches_from_numpy(bad, like)
    with pytest.raises(ValueError, match="cache keys"):
        convert.caches_from_numpy({k: v for k, v in jc.items() if k != "enc_out"}, like)


def test_both_archs_build_and_their_stages_equal_the_reference(jx):
    """Stage lists (full and reduced) equal the reference's; the full-size
    models build on the meta device with the reference's parameter counts
    (jax.eval_shape of its init) and storage dtypes (float32 norms and
    xgate)."""
    jax = jx["jax"]
    for name in ARCHS:
        for cfg, jcfg in ((configs.get(name), jx["configs"].get(name)),
                          (configs.get(name).reduced(), jx["configs"].get(name).reduced())):
            got = [dataclasses.asdict(s) for s in stages_for(cfg)]
            assert got == [dataclasses.asdict(s) for s in jx["Model"](jcfg).stages], name
        model = Model(configs.get(name), device="meta")
        jm = jx["Model"](jx["configs"].get(name))
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        assert sum(p.numel() for p in model.parameters()) == want, name
        for key, p in model.named_parameters():
            leaf = key.rsplit(".", 1)[-1]
            f32 = leaf == "xgate" or leaf.endswith(("_w", "_b"))
            assert p.dtype == (torch.float32 if f32 else torch.bfloat16), key
