"""The port's served LMs against the JAX package's, on the same parameters.

Reduced recurrentgemma-9b (hybrid: rec, rec, attn; window 64; S = 96 >
window) and reduced qwen1.5-0.5b (dense, QKV bias), with the JAX
Model.init parameters carried over by convert.model_params_from_numpy.

Tolerances, each element at its own scale:
  * rms_norm and mlp_apply in float32 within 1e-6: rms_norm of |output|
    (a pointwise product after one mean), the MLP of the magnitude bound
    |x| |w1| (x |x| |w3|) |w2| (both activations are at most |z|);
  * rope in float32 within 1e-6 of |x1| + |x2|, plus what a one-ulp change
    of its float32 frequency moves the angle at that position: XLA's
    float32 exp on the CPU is not correctly rounded, and the port's
    frequencies differ from JAX's by one ulp in a few entries (ROADMAP.md
    section 3), so the angle error grows with position as pos * ulp(freq);
  * the whole model with COMPUTE_DTYPE set to float32 in both packages
    within 1e-5 of each position's largest |logit|: the same math, summed
    in other orders;
  * blocks and whole-model logits in bf16 within 2e-2 of each position's
    largest magnitude, and never looser than the JAX package's own bound
    for two paths of one bf16 model, 0.05 * max(1, max |logits|). The two
    round to bf16 at other places (the JAX core pre-scales q in bf16 and
    rounds its scores and AV products to bf16, where the kernel keeps them
    in float32; XLA keeps excess precision across fused elementwise ops):
    one block moves the residual stream by one bf16 ulp (2^-8 of the value)
    in places, and three layers compound that to 1.3e-2 (measured 1.27e-2
    and 1.17e-2 for the two archs; ROADMAP.md section 3).

The parity tests run the JAX package on the CPU and skip where JAX's
backend is another. The tests at the end (stage lists, decode against
forward, long decode past the window) need no JAX and run on the card
when there is one. The vision and audio families are held against the JAX
package in test_torch_vlm_audio.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.models import Model, layers, stages_for  # noqa: E402
from repro_torch.models.blocks import block_apply  # noqa: E402

ARCHS = ["recurrentgemma-9b", "qwen1.5-0.5b"]
MODEL_TOL = 2e-2
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, so the tests that need no
    JAX run on a machine without it)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro.models import blocks as jblocks
    from repro.models import layers as jlayers
    return dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel, blocks=jblocks,
                layers=jlayers)


@pytest.fixture
def dev():
    """The card when there is one, else the CPU (decided at run time)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _pair(jx, name):
    """(JAX model, its params as numpy, port model on the CPU with them)."""
    jcfg = jx["configs"].get(name).reduced()
    jm = jx["Model"](jcfg, remat=False)
    params = jm.init(jx["jax"].random.PRNGKey(0))
    tree = jx["jax"].tree.map(np.asarray, params)
    model = convert.model_params_from_numpy(
        Model(configs.get(name).reduced(), device="cpu"), tree)
    return jm, params, tree, model


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _model_check(got, want, what, tol=MODEL_TOL):
    """Each position within tol of its largest |value|, and within the JAX
    package's 0.05 * max(1, max |value|) overall. Returns the worst reading."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    row = np.abs(want).max(axis=-1, keepdims=True)
    worst = float((diff / np.maximum(row, 1e-30)).max())
    assert worst <= tol, f"{what}: worst {worst:.3e} of the position's max > {tol}"
    assert diff.max() <= 0.05 * max(1.0, float(np.abs(want).max())), what
    return worst


def test_config_registry_equals_the_reference(jx):
    assert configs.all_names() == jx["configs"].all_names()
    for name in configs.all_names():
        for c, jc in ((configs.get(name), jx["configs"].get(name)),
                      (configs.get(name).reduced(), jx["configs"].get(name).reduced())):
            assert dataclasses.asdict(c) == dataclasses.asdict(jc), name
            assert c.hd == jc.hd
        for shape in configs.SHAPES:
            assert configs.shape_applicable(configs.get(name), shape) == \
                jx["configs"].shape_applicable(jx["configs"].get(name), shape)
    assert configs.SHAPES == jx["configs"].SHAPES
    assert configs.SUBQUADRATIC == jx["configs"].SUBQUADRATIC


def test_rms_norm_and_mlp_f32(jx):
    jnp, jl = jx["jnp"], jx["layers"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    w = (0.1 * rng.standard_normal(128)).astype(np.float32)
    got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    assert (np.abs(got - want) <= 1e-6 * np.abs(want)).all()
    for act in ("gelu", "swiglu"):
        # weights on the bf16 grid, so JAX's cast to bf16 at use is exact
        p = {k: torch.from_numpy((0.05 * rng.standard_normal(d.shape)).astype(np.float32))
             .to(torch.bfloat16).float() for k, d in layers.mlp_defs(128, 256, act).items()}
        got = layers.mlp_apply(p, torch.from_numpy(x), act, p["w1"].shape[1]).numpy()
        want = np.asarray(jl.mlp_apply({k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                       jnp.asarray(x), act))
        ax, a = np.abs(x), {k: np.abs(v.numpy()) for k, v in p.items()}
        hid = ax @ a["w1"] if act == "gelu" else (ax @ a["w1"]) * (ax @ a["w3"])
        assert (np.abs(got - want) <= 1e-6 * (hid @ a["w2"])).all(), act


@pytest.mark.parametrize("hd,theta", [(32, 1e4), (256, 1e4), (64, 1e6)])
def test_rope_f32_to_4096(jx, hd, theta):
    jnp, jl = jx["jnp"], jx["layers"]
    half = hd // 2
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((1, 4097, 2, hd)).astype(np.float32)
    pos = np.arange(4097, dtype=np.int32)[None]
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy()
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    # the two frequency tables, built the same way, agree to one ulp
    log_t = torch.log(torch.tensor(theta, dtype=torch.float32)) / half
    f_port = torch.exp(-torch.arange(half, dtype=torch.float32) * log_t).numpy()
    f_jax = np.asarray(jnp.exp(-jnp.arange(half, dtype=jnp.float32) * (jnp.log(theta) / half)))
    assert (np.abs(f_port - f_jax) <= np.spacing(np.maximum(f_port, f_jax))).all()
    mag = np.abs(x[..., :half]) + np.abs(x[..., half:])
    # a one-ulp frequency moves the float32 angle by pos * ulp(freq), and
    # its rounding to float32 by up to one ulp of the angle more
    ang = pos[0][:, None].astype(np.float32) * f_port[None, :]       # (S, half)
    ang_err = pos[0][:, None] * np.spacing(f_port)[None, :] + np.spacing(ang)
    bound = mag * (1e-6 + ang_err[None, :, None, :])
    diff = np.abs(got - want)
    assert (diff[..., :half] <= bound).all() and (diff[..., half:] <= bound).all()


@pytest.mark.parametrize("kind_index", [0, 2])
def test_one_rec_and_one_attn_block(jx, kind_index):
    """Layer 0 (rec) and layer 2 (attn, window 64, S = 96) of the reduced
    recurrentgemma on the same bf16 input."""
    jm, params, tree, model = _pair(jx, "recurrentgemma-9b")
    jnp, jax = jx["jnp"], jx["jax"]
    stage = 0 if kind_index == 0 else 1
    spec = model.stages[stage]
    rng = np.random.default_rng(kind_index)
    x = torch.from_numpy(rng.standard_normal((2, 96, 128)).astype(np.float32)).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(96, dtype=np.int32), (2, 96))
    got, _, _ = block_apply(model.cfg, spec, model.stage_layers[stage][0].p.tree(), x,
                            {"pos": torch.from_numpy(pos.copy())})
    p0 = jax.tree.map(lambda a: a[0], params["stages"][stage])
    want, _, _ = jx["blocks"].block_apply(jm.cfg, jm.stages[stage], p0,
                                          jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                          {"pos": jnp.asarray(pos)})
    assert spec.kind == ("rec" if kind_index == 0 else "attn")
    _model_check(got.float(), want, f"{spec.kind} block")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_logits_match_the_reference(jx, name):
    jm, params, tree, model = _pair(jx, name)
    tokens = make_batch(3, 0, 2, 96, model.cfg.vocab_size, device="cpu")["tokens"]
    got, _, _ = model(tokens)
    want, _, _ = jm.forward(params, jx["jnp"].asarray(tokens.numpy()))
    worst = _model_check(got, want, f"{name} forward logits")
    print(f"{name}: worst logit error {worst:.3e} of the position's max |logit| (bf16)")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_in_float32_matches_the_reference(jx, name, monkeypatch):
    """Both models with their compute dtype set to float32: the same
    function to float32 summation order, so the bf16 gap above is rounding
    placement and not math."""
    import repro.models.attention
    import repro.models.layers
    import repro.models.recurrent

    import repro_torch.models.attention
    import repro_torch.models.recurrent
    for mod in (repro.models.attention, repro.models.layers, repro.models.recurrent):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jx["jnp"].float32)
    for mod in (repro_torch.models.attention, layers, repro_torch.models.recurrent):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    jm, params, tree, _ = _pair(jx, name)
    model = convert.model_params_from_numpy(
        Model(configs.get(name).reduced(), device="cpu").float(), tree)
    tokens = make_batch(3, 0, 2, 96, model.cfg.vocab_size, device="cpu")["tokens"]
    got, _, _ = model(tokens)
    want, _, _ = jm.forward(params, jx["jnp"].asarray(tokens.numpy()))
    worst = _model_check(got, want, f"{name} float32 forward logits", F32_TOL)
    print(f"{name}: worst logit error {worst:.3e} of the position's max |logit| (float32)")


# -- without JAX: these run on the card when there is one ----------------------
def test_stage_lists():
    assert [s.kind for s in stages_for(configs.get("qwen2-1.5b"))] == ["attn"]
    assert stages_for(configs.get("qwen1.5-0.5b"))[0].n_layers == 24
    rg = stages_for(configs.get("recurrentgemma-9b"))
    assert sum(s.n_layers for s in rg) == 38
    assert rg[0].kind == "rec" and rg[0].n_layers == 2
    assert rg[1].kind == "attn" and rg[1].n_layers == 1 and rg[1].window == 2048
    assert sum(s.n_layers for s in rg if s.kind == "attn") == 12
    assert [s.cache for s in rg[:2]] == ["rglru", "kv"]
    xl = stages_for(configs.get("xlstm-125m"))
    assert sum(s.n_layers for s in xl) == 12
    assert {s.kind for s in xl} == {"mlstm", "slstm"}
    ds = stages_for(configs.get("deepseek-moe-16b"))
    assert ds[0].moe is False and ds[0].n_layers == 1
    assert ds[1].moe is True and ds[1].n_layers == 27
    vl = stages_for(configs.get("llama-3.2-vision-11b"))
    assert sum(s.n_layers for s in vl) == 40
    assert sum(s.n_layers for s in vl if s.kind == "cross") == 8
    ws = stages_for(configs.get("whisper-small"))
    assert [s.kind for s in ws] == ["enc", "dec"]


@pytest.mark.parametrize("name", ARCHS)
def test_decode_after_prefill_matches_forward(name, dev):
    cfg = configs.get(name).reduced()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    b, s, k = 2, 80, 6
    tokens = make_batch(1, 0, b, s, cfg.vocab_size, device=dev)["tokens"]
    full, _, _ = model(tokens)
    tol = 0.05 * max(1.0, float(full.abs().max()))
    logits, caches = model.prefill({"tokens": tokens[:, :s - k]}, max_len=s + 8)
    assert float((logits - full[:, s - k - 1]).abs().max()) < tol
    for i in range(k):
        logits, caches = model.decode_step(caches, tokens[:, s - k + i:s - k + i + 1])
        err = float((logits - full[:, s - k + i]).abs().max())
        assert err < tol, (name, i, err)
    assert int(caches["pos"][0]) == s


def test_long_decode_past_the_window_stays_finite(dev):
    """Local-window ring cache: 80 decode steps past the reduced window of
    64 stay finite, and the attention caches stay window-sized."""
    cfg = configs.get("recurrentgemma-9b").reduced()
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    caches = model.make_caches(1, max_len=256)
    tok = torch.ones((1, 1), dtype=torch.int32, device=dev)
    for _ in range(80):
        logits, caches = model.decode_step(caches, tok)
    assert bool(torch.isfinite(logits).all())
    kv = caches["stages"][1]["kv"]
    assert kv["k"].shape[2] == cfg.window == 64
    assert sorted(kv["pos"][0, 0].tolist()) == list(range(16, 80))
