"""The compiled serve steps (runtime/serve.py: jit_prefill, jit_decode_step,
jit_masked_decode_step) against the JAX package's, on the CPU, where they
run eagerly on their static buffers.

Six reduced families: qwen1.5-0.5b (dense), recurrentgemma-9b (hybrid),
deepseek-moe-16b (MoE, top-2), xlstm-125m (mLSTM / sLSTM), whisper-small
(audio) and llama-3.2-vision-11b (vlm), each with the reference's
Model.init(PRNGKey(0)) parameters carried across by
convert.model_params_from_numpy; the vision and audio trees are edited as
tests/test_torch_vlm_audio.py edits them (xgate 0.5 / -0.7, random
LayerNorm leaves), so the cross paths add something. The reference's
programs run with a mesh of one device, make_mesh((1, 1), ("data",
"model")); the port's take None, a device or a list of one.

Per family: a prefill (with a frontend for the vision and audio families),
4 decode steps and 2 masked steps with slot 1 inactive, the logits of each
held to the JAX package's bound for two paths of one bf16 model,
0.05 * max(1, max |logits|) (tripled for a top-1 MoE, as
tests/test_torch_moe.py triples it); the inactive slot's caches equal to the
bit before and after each masked step. With the compute dtype set to
float32 in both packages (the dense and hybrid families, as
tests/test_torch_models.py sets it) the logits agree to 1e-5 of each
position's largest |logit|.

Without JAX: the programs' in-place steps equal the functional path
(Model.decode_step; for the masked step, slot_where over it) to the bit,
caches leaf for leaf; the steady state takes its own caches back without a
copy; compile_log records a program once a shape; a mesh of two devices
raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_vlm_audio import _edited_tree  # noqa: E402

from repro_torch import configs, convert, graphs  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402
from repro_torch.models import Model, attention, layers, recurrent  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.online import slot_where  # noqa: E402
from repro_torch.planning import compile_log  # noqa: E402
from repro_torch.runtime import serve  # noqa: E402

FAMILIES = ["qwen1.5-0.5b", "recurrentgemma-9b", "deepseek-moe-16b", "xlstm-125m",
            "whisper-small", "llama-3.2-vision-11b"]
B, S, MAX_LEN, DECODE, MASKED = 3, 8, 16, 4, 2
ACTIVE = [True, False, True]
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch.mesh import make_mesh
    from repro.models import Model as JModel
    from repro.runtime import serve as jserve
    return dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel, serve=jserve,
                mesh=make_mesh((1, 1), ("data", "model")))


def _pair(jx, name, float32=False):
    """(JAX model, its params, the port's model on the CPU with them)."""
    jax = jx["jax"]
    jm = jx["Model"](jx["configs"].get(name).reduced(), remat=False)
    if jm.cfg.family in ("vlm", "audio"):
        tree = _edited_tree(jx, jm, jm.cfg.family)
    else:
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = jax.tree.map(jx["jnp"].asarray, tree)
    model = Model(configs.get(name).reduced(), device="cpu")
    if float32:
        model = model.float()
    return jm, params, convert.model_params_from_numpy(model, tree)


def _inputs(cfg, seed):
    """Prompt tokens (B, S), DECODE + MASKED decode tokens (B, 1) and, for
    the vision and audio families, a frontend (B, Sf, D), from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(DECODE + MASKED)]
    front = None
    if cfg.family in ("vlm", "audio"):
        front = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, steps, front


def _bound(cfg, want) -> float:
    top1 = 3.0 if getattr(cfg, "top_k", 0) == 1 else 1.0
    return top1 * 0.05 * max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


def _near(got, want, cfg, what, rows=None, f32=False):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[rows], want[rows]
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    if f32:
        scale = np.abs(want).max(-1, keepdims=True)
        worst = float((err / np.maximum(scale, 1e-30)).max())
        assert worst <= F32_TOL, (what, worst)
    else:
        assert float(err.max()) <= _bound(cfg, want), (what, float(err.max()),
                                                       _bound(cfg, want))


def _slot(caches, i):
    """Every leaf's slot i, cloned (stage leaves (L, B, ...), the rest (B, ...))."""
    out = [caches["pos"][i].clone()]
    for st in caches["stages"]:
        if st is not None:
            out += [leaf[:, i].clone() for leaf in tree_flatten(st)[0]]
    return out


def _run(jx, name, float32=False):
    """Both packages' prefill, decode steps and masked steps on the same
    inputs; every logits row held to the bound (or to F32_TOL)."""
    jnp, jserve, mesh = jx["jnp"], jx["serve"], jx["mesh"]
    jm, params, model = _pair(jx, name, float32)
    cfg = model.cfg
    toks, steps, front = _inputs(cfg, 0)
    jbatch, batch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if front is not None:
        jbatch["frontend"], batch["frontend"] = jnp.asarray(front), torch.from_numpy(front)

    jpre, _ = jserve.jit_prefill(jm, mesh, MAX_LEN)
    pre, place = serve.jit_prefill(model, None, MAX_LEN)
    assert place == torch.device("cpu")
    jlog, jc = jpre(params, jbatch)
    log, c = pre(None, batch)
    _near(log, jlog, cfg, (name, "prefill"), f32=float32)

    jdec, _, _ = jserve.jit_decode_step(jm, mesh, B, MAX_LEN)
    dec, _, c_place = serve.jit_decode_step(model, torch.device("cpu"), B, MAX_LEN)
    assert c_place == torch.device("cpu")
    for k in range(DECODE):
        jlog, jc = jdec(params, jc, jnp.asarray(steps[k]))
        log, c_new = dec(None, c, torch.from_numpy(steps[k]))
        if k:       # the steady state: the step's own buffers come back
            assert all(a is b for a, b in zip(tree_flatten(c_new)[0], tree_flatten(c)[0]))
        c = c_new
        _near(log, jlog, cfg, (name, "decode", k), f32=float32)

    jmask, _, _ = jserve.jit_masked_decode_step(jm, mesh, B, MAX_LEN)
    masked, _, _ = serve.jit_masked_decode_step(model, [torch.device("cpu")], B, MAX_LEN)
    active = torch.tensor(ACTIVE)
    rows = np.flatnonzero(ACTIVE)
    for k in range(DECODE, DECODE + MASKED):
        frozen = _slot(c, 1)
        jlog, jc = jmask(params, jc, jnp.asarray(steps[k]), jnp.asarray(ACTIVE))
        log, c = masked(None, c, torch.from_numpy(steps[k]), active)
        assert all(torch.equal(a, b) for a, b in zip(frozen, _slot(c, 1))), (name, k)
        _near(log, jlog, cfg, (name, "masked", k), rows=rows, f32=float32)


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_steps_match_the_reference(jx, name):
    _run(jx, name)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "recurrentgemma-9b"])
def test_serve_steps_in_float32_match_the_reference(jx, name, monkeypatch):
    import repro.models.attention
    import repro.models.layers
    import repro.models.recurrent
    for mod in (repro.models.attention, repro.models.layers, repro.models.recurrent):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx["jnp"].float32)
    for mod in (attention, layers, recurrent, tmodel):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    _run(jx, name, float32=True)


# -- without JAX -----------------------------------------------------------------
def _model(name):
    cfg = configs.get(name).reduced()
    return Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


def _equal_trees(got, want, what):
    assert str(tree_flatten(got)[1]) == str(tree_flatten(want)[1]), what
    bad = graphs.differing(got, want)
    assert not bad, (what, bad)


@pytest.mark.parametrize("name", FAMILIES)
def test_in_place_steps_equal_the_functional_path(name):
    """The programs' steps (ring writes and states in place, masked slots
    put back) against Model.decode_step and slot_where on copies of the
    same caches: logits and every cache leaf to the bit."""
    model = _model(name)
    cfg = model.cfg
    toks, steps, front = _inputs(cfg, 1)
    batch = {"tokens": torch.from_numpy(toks)}
    if front is not None:
        batch["frontend"] = torch.from_numpy(front)
    pre, _ = serve.jit_prefill(model, None, MAX_LEN)
    log, caches = pre(None, batch)
    want_log, want = model.prefill(batch, MAX_LEN)
    assert torch.equal(log, want_log)
    _equal_trees(caches, want, (name, "prefill"))
    dec, _, _ = serve.jit_decode_step(model, None, B, MAX_LEN)
    for k in range(DECODE):
        tok = torch.from_numpy(steps[k])
        want_log, want = model.decode_step(want, tok)
        log, caches = dec(None, caches, tok)
        assert torch.equal(log, want_log), (name, k)
        _equal_trees(caches, want, (name, "decode", k))
    masked, _, _ = serve.jit_masked_decode_step(model, None, B, MAX_LEN)
    active = torch.tensor(ACTIVE)
    for k in range(DECODE, DECODE + MASKED):
        tok = torch.from_numpy(steps[k])
        want_log, new = model.decode_step(want, torch.where(active[:, None], tok, 0))
        want = slot_where(active, new, want)
        log, caches = masked(None, caches, tok, active)
        assert torch.equal(log, want_log), (name, k)
        _equal_trees(caches, want, (name, "masked", k))


def test_programs_build_once_a_shape():
    model = _model("qwen1.5-0.5b")
    rng = np.random.default_rng(2)
    pre, _ = serve.jit_prefill(model, None, MAX_LEN)
    dec, _, _ = serve.jit_decode_step(model, None, 2, MAX_LEN)

    def toks(s):
        return torch.from_numpy(rng.integers(0, 512, (2, s)).astype(np.int32))
    with compile_log() as log:
        _, c = pre(None, {"tokens": toks(5)})
        pre(None, {"tokens": toks(5)})
        pre(None, {"tokens": toks(7)})
        for _ in range(3):
            _, c = dec(None, c, toks(1))
    assert log == ["prefill", "prefill", "decode_step"]
    assert len(pre.program.keys()) == 2 and len(dec.program.keys()) == 1


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "llama-3.2-vision-11b"])
def test_batcher_admits_into_its_live_caches(name):
    """DecodeBatcher's admission (jit_prefill_into) writes each prefill
    into its slot of the live caches, which both programs hold as their
    buffers: the cache tensors stay the same objects across admissions of
    two prompt lengths and masked steps, the admission builds one key a
    length, and the slots equal slot_update of Model.prefill's caches to
    the bit."""
    from repro_torch.online import DecodeBatcher, slot_update
    model = _model(name)
    toks, steps, _ = _inputs(model.cfg, 3)
    lens = [S, S - 3, S]
    db = DecodeBatcher(model, None, capacity=B, max_len=MAX_LEN)
    live = graphs.tensors(db.caches)
    want = model.make_caches(B, MAX_LEN)
    with compile_log() as log:
        for i, n in enumerate(lens):
            prompt = torch.from_numpy(toks[i:i + 1, :n])
            got = db.admit(i, prompt)
            logits, one = model.prefill({"tokens": prompt}, MAX_LEN)
            want = slot_update(want, i, one)
            assert torch.equal(got, logits[0]), (name, i)
        _equal_trees(db.caches, want, (name, "admitted"))
        active = torch.tensor(ACTIVE)
        for k in range(MASKED):
            db.step(torch.from_numpy(steps[k]), active)
    assert log == ["prefill", "prefill", "masked_decode_step"]
    assert len(db.programs[0].keys()) == 2
    assert all(a is b for a, b in zip(graphs.tensors(db.caches), live))


def test_params_and_meshes_are_refused():
    model = _model("qwen1.5-0.5b")
    cpu = torch.device("cpu")
    for mesh in ([cpu, cpu], (cpu, cpu, cpu, cpu)):
        with pytest.raises(NotImplementedError, match="sharding"):
            serve.jit_prefill(model, mesh, MAX_LEN)
        with pytest.raises(NotImplementedError, match="sharding"):
            serve.jit_decode_step(model, mesh, 2, MAX_LEN)
        with pytest.raises(NotImplementedError, match="sharding"):
            serve.jit_masked_decode_step(model, mesh, 2, MAX_LEN)
    with pytest.raises(ValueError, match="not the model's device"):
        serve.jit_prefill(model, "meta", MAX_LEN)
    pre, _ = serve.jit_prefill(model, "cpu", MAX_LEN)
    with pytest.raises(ValueError, match="params=None"):
        pre({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    dec, _, _ = serve.jit_masked_decode_step(model, None, 2, MAX_LEN)
    with pytest.raises(TypeError, match="active"):
        dec(None, model.make_caches(2, MAX_LEN), torch.zeros((2, 1), dtype=torch.int32))
