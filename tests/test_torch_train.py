"""The port's training slice against the JAX package's, on the CPU: optim/
(AdamW, the cosine schedule, global-norm clipping, top-k compression),
data.SyntheticLM, runtime/train.py and launch/train.py, on the reduced
qwen1.5-0.5b (3 layers, d_model 128, vocab 512).

Inputs come from numpy seeds or from the JAX package's own state, carried
over by convert.train_state_from_numpy. Tolerances, each stated where it
is used:
  * the optimizer functions on the same trees in float32: the same
    operations in the same order, within 1e-6 of each element's terms
    (XLA may contract a multiply-add where PyTorch rounds twice);
  * a train step with COMPUTE_DTYPE float32 in both packages: the loss
    within 1e-5 of itself, each gradient and moment leaf within 1e-5 of the
    leaf's largest magnitude (measured: 1.0e-6; float32 sums over the batch
    in another order); the updated params within adamw_bound (below);
  * the same step in bf16: the JAX package's own bound for two paths of one
    bf16 model, 0.05 of the largest magnitude (of the loss, and of each
    gradient and moment leaf); measured 2.7e-2 on the smallest bias leaves
    (bf16 rounding placement, ROADMAP.md section 3);
  * microbatching (4 against 1) and the chunked against the unchunked
    cross-entropy as the JAX package's tests hold them.

adamw_bound: AdamW's update is lr * m_hat / (sqrt(v_hat) + eps) (plus
weight decay). Where sqrt(v_hat) is near the gradient's own error, the
ratio can move by up to about 2 (a gradient that is zero up to rounding
flips sign: the first-step trap of ROADMAP.md section 3). So each updated
param is held to the rounding of the update plus lr times the first-order
move of the ratio under the gradient's bound E (m by (1 - b1) E, v by
(1 - b2)(2 |g| E + E^2)): tight where v_hat is large, loose only where a
flip can happen. Every element is checked; none is left out. The test
prints how many elements lean on the flip allowance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import load_checkpoint  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402
from repro_torch.data import SyntheticLM, make_batch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.optim import compression as t_comp  # noqa: E402
from repro_torch.runtime import train as t_train  # noqa: E402

ARCH = "qwen1.5-0.5b"
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
BASE_LR = 3e-3


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here: the tests below that need
    no JAX never touch them)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    import repro.models.attention
    import repro.models.layers
    from repro import configs as jconfigs
    from repro.data import SyntheticLM as JSyntheticLM
    from repro.data import make_batch as jmake_batch
    from repro.models import Model as JModel
    from repro.optim import adamw as jadamw
    from repro.optim import compression as jcomp
    from repro.runtime import train as jtrain
    return dict(jax=jax, jnp=jnp, configs=jconfigs, Model=JModel, adamw=jadamw, comp=jcomp,
                train=jtrain, make_batch=jmake_batch, SyntheticLM=JSyntheticLM,
                attention=repro.models.attention, layers=repro.models.layers)


def _np(tree, jax):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _stacked(tree):
    """A port tree in Model.param_tree()'s layout as numpy, its stages'
    per-layer leaves stacked as the JAX package's [L, ...] leaves."""
    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return np.stack([x.detach().float().numpy() for x in layers])
    out = {k: v.detach().float().numpy() for k, v in tree.items() if k != "stages"}
    out["stages"] = [stack(layers) for layers in tree["stages"]]
    return out


def _paired_leaves(jax, ref, port):
    """(path, reference leaf, port leaf) over the JAX tree's leaves, the port
    tree restacked into the same layout."""
    got = jax.tree.leaves(_stacked(port))
    want = jax.tree_util.tree_leaves_with_path(_np(ref, jax))
    assert len(got) == len(want)
    return [(jax.tree_util.keystr(p), w, g) for (p, w), g in zip(want, got)]


def _leafwise(jax, ref, port, tol, what):
    """Each element within tol of its leaf's largest |reference| value.
    Returns the worst reading."""
    worst = 0.0
    for path, w, g in _paired_leaves(jax, ref, port):
        assert g.shape == w.shape, (what, path)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        worst = max(worst, err)
        assert err <= tol, f"{what} {path}: {err:.3e} of the leaf's largest value > {tol}"
    return worst


def adamw_bound(p, g, m, v, t, lr, e):
    """Per-element bound on |new param (port) - new param (reference)|
    (module docstring): p, g, m, v the reference's param, gradient and new
    moments, t the new step, e the gradient's bound. Returns (bound, mask of
    the elements whose allowance exceeds 1e-3 lr: where a flip can move
    the ratio)."""
    c1, c2 = 1 - B1 ** t, 1 - B2 ** t
    sv = np.sqrt(v / c2)
    dm = (1 - B1) * e / c1
    dv = (1 - B2) * (2 * np.abs(g) * e + e * e) / c2
    dsv = np.minimum(np.sqrt(dv), dv / np.maximum(2 * sv, 1e-30))   # |sqrt(a+d) - sqrt(a)|
    ratio = np.abs(m / c1) / (sv + EPS)
    move = dm / (sv + EPS) + np.abs(m / c1) * dsv / (sv + EPS) ** 2
    rounding = 4e-7 * (np.abs(p) + lr * (ratio + WD * np.abs(p)))
    allow = lr * move
    return rounding + allow, allow > 1e-3 * lr


# -- optim/ on the same trees -------------------------------------------------------
def _tree(rng):
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 3)}, "stages": [{"w": (4, 6)},
                                                                         {"w": (2,)}]}

    def draw(x):
        if isinstance(x, dict):
            return {k: draw(v) for k, v in x.items()}
        if isinstance(x, list):
            return [draw(v) for v in x]
        return rng.standard_normal(x).astype(np.float32)
    return draw(shapes)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def _torch_leaves(tree):
    return [x.numpy() for x in tree_flatten(tree)[0]]


def _close_terms(got, want, scale, tol, what):
    err = np.abs(np.asarray(got) - np.asarray(want)) / np.maximum(scale, 1e-30)
    assert err.max() <= tol, f"{what}: {err.max():.3e} of its terms > {tol}"


def test_adamw_matches_the_reference(jx):
    """Five AdamW steps on the same trees and gradients (with lr from the
    cosine schedule at steps 0..4 of a 3-step warmup), leaf by leaf: m, v
    and params within 1e-6 of the magnitude of their terms."""
    jax, jnp, ja = jx["jax"], jx["jnp"], jx["adamw"]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = ja.adamw_init(jp), t_adamw.adamw_init(tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for i in range(5):
        grads = _tree(rng)
        grads["a"][0, 0] = 0.0                   # an exact zero gradient
        jlr = ja.cosine_lr(jnp.int32(i), base_lr=1e-2, warmup=3, total=20)
        tlr = t_adamw.cosine_lr(torch.tensor(i, dtype=torch.int32), base_lr=1e-2, warmup=3,
                                total=20)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        prev_m, prev_v = _torch_leaves(ts.m), _torch_leaves(ts.v)
        prev_p = _torch_leaves(tp)
        jp, js = ja.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js, jlr)
        tp, ts = t_adamw.adamw_update(tp, _to_torch(grads), ts, tlr)
        assert int(ts.step) == int(js.step) == i + 1 and ts.step.dtype == torch.int32
        lr = float(jlr)
        for k, (g, m0, v0, p0) in enumerate(zip(jax.tree.leaves(grads), prev_m, prev_v,
                                                prev_p)):
            m_w, v_w = np.asarray(jax.tree.leaves(js.m)[k]), np.asarray(jax.tree.leaves(js.v)[k])
            _close_terms(_torch_leaves(ts.m)[k], m_w, B1 * np.abs(m0) + (1 - B1) * np.abs(g),
                         1e-6, f"m leaf {k} step {i}")
            _close_terms(_torch_leaves(ts.v)[k], v_w, B2 * v0 + (1 - B2) * g * g, 1e-6,
                         f"v leaf {k} step {i}")
            t = i + 1
            ratio = np.abs(m_w / (1 - B1 ** t)) / (np.sqrt(v_w / (1 - B2 ** t)) + EPS)
            _close_terms(_torch_leaves(tp)[k], np.asarray(jax.tree.leaves(jp)[k]),
                         np.abs(p0) + lr * (ratio + WD * np.abs(p0)), 1e-6,
                         f"param leaf {k} step {i}")


@pytest.mark.parametrize("base_lr,warmup,total,min_frac", [(3e-4, 100, 10000, 0.1),
                                                           (1e-3, 10, 100, 0.1),
                                                           (2e-2, 0, 50, 0.0)])
def test_cosine_lr_matches_the_reference(jx, base_lr, warmup, total, min_frac):
    """Warmup, decay and floor at float32, within 1e-6 relative."""
    jnp, ja = jx["jnp"], jx["adamw"]
    for s in (0, 1, warmup // 2, max(0, warmup - 1), warmup, warmup + 1, total // 2,
              total - 1, total, total + 7):
        want = float(ja.cosine_lr(jnp.int32(s), base_lr=base_lr, warmup=warmup, total=total,
                                  min_frac=min_frac))
        got = t_adamw.cosine_lr(torch.tensor(s, dtype=torch.int32), base_lr=base_lr,
                                warmup=warmup, total=total, min_frac=min_frac)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(jx, max_norm):
    """The norm within 1e-6 relative (the leaves' sums of squares in the same
    sorted-key order; each leaf's own sum in another order), the clipped
    leaves within 1e-6 of their values."""
    jax, jnp, ja = jx["jax"], jx["jnp"], jx["adamw"]
    grads = _tree(np.random.default_rng(1))
    jg, jn = ja.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
    tg, tn = t_adamw.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(_torch_leaves(tg), jax.tree.leaves(jg)):
        _close_terms(got, np.asarray(want), np.abs(np.asarray(want)), 1e-6, "clipped leaf")


@pytest.mark.parametrize("chunk", [1 << 26, 5])
def test_in_place_adamw_and_clip_equal_the_pure_functions_to_the_bit(monkeypatch, chunk):
    """clip_by_global_norm_ and adamw_update_ on copies of the same trees
    give the pure functions' bits (norm, clipped gradients, m, v, params,
    step) over four steps; the returned state holds the tensors it was
    given. chunk 5 splits every leaf into flat chunks of 5 elements (the
    in-place functions' CHUNK), with a ragged last chunk."""
    monkeypatch.setattr(t_adamw, "CHUNK", chunk)
    rng = np.random.default_rng(4)
    params = _to_torch(_tree(rng))
    mine = _to_torch(_tree(np.random.default_rng(4)))
    pure_state, state = t_adamw.adamw_init(params), t_adamw.adamw_init(mine)
    m_ids = [id(x) for x in tree_flatten(state.m)[0]]
    for i in range(4):
        grads = _tree(rng)
        grads["a"][1, 2] = 0.0
        g_pure, n_pure = t_adamw.clip_by_global_norm(_to_torch(grads), 0.5)
        g_mine, n_mine = t_adamw.clip_by_global_norm_(_to_torch(grads), 0.5)
        assert torch.equal(n_pure, n_mine)
        lr = t_adamw.cosine_lr(torch.tensor(i + 3, dtype=torch.int32), base_lr=1e-2, warmup=3,
                               total=20)
        params, pure_state = t_adamw.adamw_update(params, g_pure, pure_state, lr)
        out, state = t_adamw.adamw_update_(mine, g_mine, state, lr)
        assert out is mine and [id(x) for x in tree_flatten(state.m)[0]] == m_ids
        assert torch.equal(state.step, pure_state.step) and state.step.dtype == torch.int32
        for a, b in zip(tree_flatten((g_pure, params, pure_state.m, pure_state.v))[0],
                        tree_flatten((g_mine, mine, state.m, state.v))[0], strict=True):
            assert torch.equal(a, b)


def test_compression_matches_the_reference(jx):
    """compress_topk picks the same values and indices (distinct magnitudes),
    decompress_topk scatters them back, and eight error-feedback steps
    send and keep the same amounts: exact, the same float32 operations."""
    jnp, jc = jx["jnp"], jx["comp"]
    rng = np.random.default_rng(2)
    signs = rng.choice(np.array([-1.0, 1.0], np.float32), 600)
    g = (signs * rng.permutation(np.arange(1, 601, dtype=np.float32)) / 100).reshape(20, 30)
    for k_frac in (0.01, 0.1, 0.5):
        jv, ji = jc.compress_topk(jnp.asarray(g), k_frac)
        tv, ti = t_comp.compress_topk(torch.from_numpy(g), k_frac)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            t_comp.decompress_topk(tv, ti, g.shape, torch.float32).numpy(),
            np.asarray(jc.decompress_topk(jv, ji, g.shape, jnp.float32)))
    gs = rng.standard_normal((6, 7)).astype(np.float32)
    jr, tr = jnp.zeros_like(jnp.asarray(gs)), torch.zeros(6, 7)
    for _ in range(8):
        jh, jr = jc.error_feedback_update(jnp.asarray(gs), jr, k_frac=0.1)
        th, tr = t_comp.error_feedback_update(torch.from_numpy(gs), tr, k_frac=0.1)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_synthetic_lm_equals_the_reference_and_resumes(jx):
    """The same batches, step by step, from step 0 and from start_step 5,
    with a frontend; the resumed stream equals the tail of the first."""
    shape = (3, 8)
    ref = jx["SyntheticLM"](7, 4, 16, 100, shape)
    port = SyntheticLM(7, 4, 16, 100, shape, device="cpu")
    firsts = []
    for _ in range(8):
        want, got = next(ref), next(port)
        for key in ("tokens", "targets"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        np.testing.assert_array_equal(got["frontend"].float().numpy(),
                                      np.asarray(want["frontend"], np.float32))
        firsts.append(got)
    assert port.step == 8
    ref.close()
    port.close()
    resumed = SyntheticLM(7, 4, 16, 100, shape, start_step=5, device="cpu")
    for want in firsts[5:]:
        got = next(resumed)
        for key in want:
            assert torch.equal(got[key], want[key])
    resumed.close()


# -- one train step against the reference --------------------------------------------
# the model modules that bind COMPUTE_DTYPE, in both packages
COMPUTE_MODULES = ("layers", "attention", "blocks", "moe", "recurrent", "xlstm", "model")


def f32_compute(mp, jx) -> None:
    """Set COMPUTE_DTYPE to float32 in every model module of both packages
    (undone when the MonkeyPatch context ends)."""
    import importlib
    for pkg, dt in (("repro.models", jx["jnp"].float32), ("repro_torch.models", torch.float32)):
        for name in COMPUTE_MODULES:
            mod = importlib.import_module(f"{pkg}.{name}")
            if hasattr(mod, "COMPUTE_DTYPE"):
                mp.setattr(mod, "COMPUTE_DTYPE", dt)


def edited_params(jx, params, family: str, seed: int = 1):
    """The reference's init tree with every cross block's xgate set to 0.5
    and -0.7 by layer (the reference initialises it to zero, where a cross
    block adds nothing and its weights get no gradient) and, for audio, the
    LayerNorm weights and biases drawn at random (1 + 0.1 N(0, 1), 0.1 N(0,
    1)): the paths a test must see."""
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(seed)

    def edit(path, a):
        key = path[-1].key
        a = np.asarray(a)
        if key == "xgate":
            return jnp.asarray(np.resize(np.asarray([0.5, -0.7], np.float32),
                                         a.shape).astype(np.float32))
        if family == "audio" and key.endswith("_b"):
            return jnp.asarray((0.1 * rng.standard_normal(a.shape)).astype(np.float32))
        if family == "audio" and key.endswith("_w"):
            return jnp.asarray((1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32))
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(edit, params)


def step_case(jx, dtype: str, arch: str = ARCH, batch: int = 4, seq: int = 32,
              moe_capacity: float = 2.0) -> dict:
    """The reference state after two steps of make_train_step (base_lr 3e-3)
    on make_batch(0, s, batch, seq) (with the launcher's frontend), from its
    init edited by edited_params, its step counters set to 100 (the end of
    the warmup: lr = base_lr, bias corrections near 1), then one more step
    on make_batch(0, 7, ...) in both packages from the same bits, with
    COMPUTE_DTYPE float32 in both when dtype is "float32". Returns the
    readings as numpy and port trees."""
    jax, jnp = jx["jax"], jx["jnp"]
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            f32_compute(mp, jx)
        cfg = jx["configs"].get(arch).reduced()
        fs = launch_train.frontend_shape(cfg, seq)
        jm = jx["Model"](cfg, remat=True, moe_capacity=moe_capacity)
        train_step = jx["train"].make_train_step(jm, base_lr=BASE_LR, total_steps=300)

        @jax.jit
        def step_and_grads(st, b):
            """The reference step and, at the same params, its loss, aux and
            gradients (one program: one compile for every step)."""
            (_, (loss, aux)), grads = jax.value_and_grad(
                lambda p: jx["train"].loss_fn(jm, p, b), has_aux=True)(st.params)
            return train_step(st, b), (loss, aux, grads)

        st = jx["train"].init_state(jm, jax.random.PRNGKey(0))
        st = st._replace(params=edited_params(jx, st.params, cfg.family))
        for s in range(2):
            (st, _), _ = step_and_grads(st, jx["make_batch"](0, s, batch, seq, cfg.vocab_size,
                                                            fs))
        st = st._replace(step=jnp.int32(100), opt=st.opt._replace(step=jnp.int32(100)))
        jbatch = jx["make_batch"](0, 7, batch, seq, cfg.vocab_size, fs)
        (st2, jmet), (jloss, jaux, jgrads) = step_and_grads(st, jbatch)

        model = Model(configs.get(arch).reduced(), device="cpu", trainable=True,
                      moe_capacity=moe_capacity)
        state = convert.train_state_from_numpy(
            model, _np(st.params, jax), _np(st.opt.m, jax), _np(st.opt.v, jax),
            np.asarray(st.opt.step), np.asarray(st.step))
        batch_t = make_batch(0, 7, batch, seq, cfg.vocab_size, fs, device="cpu")
        _, _, grads = t_train.loss_and_grads(model, batch_t)
        step = t_train.make_train_step(model, base_lr=BASE_LR, total_steps=300)
        state2, met = step(state, batch_t)
    return dict(jax_params=st.params, jax_grads=jgrads, jax_loss=float(jloss),
                jax_aux=float(jaux), jax_state=st2,
                jax_metrics={k: float(v) for k, v in jmet.items()}, grads=grads, state=state2,
                metrics={k: float(v) for k, v in met.items()})


def block_scaled_leafwise(jax, ref, port, tol, what):
    """_leafwise, with a one-element leaf (a cross block's xgate: a sum over
    every output of its block, whose terms cancel) held to tol of the
    largest |reference| value of its block's leaves instead: the same
    products its block's weight gradients sum. Returns the worst reading."""
    pairs = _paired_leaves(jax, ref, port)
    block_max: dict = {}
    for path, w, _ in pairs:
        block = path.rsplit("[", 1)[0]
        block_max[block] = max(block_max.get(block, 0.0), float(np.abs(w).max()))
    worst = 0.0
    for path, w, g in pairs:
        assert g.shape == w.shape, (what, path)
        scale = block_max[path.rsplit("[", 1)[0]] if w.size == 1 else float(np.abs(w).max())
        err = float(np.abs(g - w).max()) / max(scale, 1e-30)
        worst = max(worst, err)
        assert err <= tol, f"{what} {path}: {err:.3e} of the scale > {tol}"
    return worst


def check_f32_case(jx, case, what: str) -> None:
    """A float32 step_case: the loss and the aux loss within 1e-5 relative
    (the aux within 1e-5 of max(1, |aux|)), the global norm within 1e-5, the
    same learning rate, the steps advanced by one, each gradient and moment
    leaf within 1e-5 of its largest value (block_scaled_leafwise), the
    updated params within adamw_bound."""
    jax = jx["jax"]
    jm, m = case["jax_metrics"], case["metrics"]
    np.testing.assert_allclose(m["loss"], case["jax_loss"], rtol=1e-5)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    assert abs(m["aux"] - jm["aux"]) <= 1e-5 * max(1.0, abs(jm["aux"]))
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert m["lr"] == jm["lr"] == pytest.approx(BASE_LR)
    assert int(case["state"].step) == int(case["state"].opt.step) == 101
    worst = block_scaled_leafwise(jax, case["jax_grads"], case["grads"], 1e-5,
                                  f"{what} gradient")
    for name in ("m", "v"):
        block_scaled_leafwise(jax, getattr(case["jax_state"].opt, name),
                              getattr(case["state"].opt, name), 1e-5, f"{what} {name}")
    _check_params(jx, case, 1e-5, f"{what} float32 step")
    print(f"{what} float32 gradients: worst {worst:.3e} of the scale")


def bf16_logits_check(jx, arch: str, bound: float = 0.05, batch: int = 4, seq: int = 32):
    """The training forward in bf16 (float32 masters cast at use) against the
    JAX package's at the same edited init params (moe_capacity 2.0, the
    launcher's frontend): the logits within bound * max(1, max |logits|)
    and the loss within bound * max(1, |loss|). Returns the readings."""
    jax = jx["jax"]
    cfg = jx["configs"].get(arch).reduced()
    fs = launch_train.frontend_shape(cfg, seq)
    jm = jx["Model"](cfg, remat=True, moe_capacity=2.0)
    params = edited_params(jx, jm.init(jax.random.PRNGKey(0)), cfg.family)
    jbatch = jx["make_batch"](0, 7, batch, seq, cfg.vocab_size, fs)
    reference = jax.jit(lambda p, b: (jm.train_logits(p, b)[0],
                                      jx["train"].loss_fn(jm, p, b)[1][0]))
    jlogits, jloss = reference(params, jbatch)
    jlogits, jloss = np.asarray(jlogits, np.float32), float(jloss)
    model = Model(configs.get(arch).reduced(), device="cpu", trainable=True, moe_capacity=2.0)
    convert.model_params_from_numpy(model, _np(params, jax))
    batch_t = make_batch(0, 7, batch, seq, cfg.vocab_size, fs, device="cpu")
    with torch.no_grad():
        logits = model.train_logits(batch_t)[0].float().numpy()
        loss = float(t_train.loss_fn(model, batch_t)[1][0])
    err = float(np.abs(logits - jlogits).max()) / max(1.0, float(np.abs(jlogits).max()))
    print(f"{arch} bf16 training forward: logits within {err:.3e} of max(1, max |logits|), "
          f"loss {loss!r} / {jloss!r}")
    assert err <= bound
    assert abs(loss - jloss) <= bound * max(1.0, abs(jloss))
    return err, loss, jloss


def launch_resume_check(tmp_path, arch: str, seq: int = 32) -> None:
    """launch.train.main --reduced --device cpu for ``arch``: 3 steps
    uninterrupted; then 2 steps and a restart that resumes from the final
    checkpoint (step 2) and trains 1 more, its loss equal to the
    uninterrupted run's to the bit."""
    common = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2", "--seq",
              str(seq), "--log-every", "1", "--ckpt-every", "2"]
    full = launch_train.main(common + ["--steps", "3", "--ckpt-dir", str(tmp_path / "a")])
    first = launch_train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    again = launch_train.main(common + ["--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
    assert full["done"] == 3 and first["done"] == 2 and again["start"] == 2
    assert int(again["state"].step) == 3
    assert [first["losses"][s] for s in range(2)] == [full["losses"][s] for s in range(2)]
    assert again["losses"] == {2: full["losses"][2]}
    assert all(np.isfinite(list(full["losses"].values())))


@pytest.fixture(scope="module")
def f32_case(jx):
    return step_case(jx, "float32")


@pytest.fixture(scope="module")
def bf16_case(jx):
    return step_case(jx, "bfloat16")


def test_train_step_f32_loss_and_metrics(f32_case):
    """Loss within 1e-5 relative; the global norm within 1e-5 (sums in
    another order); the same learning rate; int32 steps advanced by one."""
    c = f32_case
    jm, m = c["jax_metrics"], c["metrics"]
    np.testing.assert_allclose(m["loss"], c["jax_loss"], rtol=1e-5)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert m["lr"] == jm["lr"] == pytest.approx(BASE_LR)
    assert c["state"].step.dtype == torch.int32 and int(c["state"].step) == 101
    assert int(c["state"].opt.step) == int(c["jax_state"].opt.step) == 101


def test_train_step_f32_gradients(jx, f32_case):
    worst = _leafwise(jx["jax"], f32_case["jax_grads"], f32_case["grads"], 1e-5, "gradient")
    print(f"float32 gradients: worst {worst:.3e} of the leaf's largest value")


def test_train_step_f32_moments(jx, f32_case):
    st, jst = f32_case["state"], f32_case["jax_state"]
    for name in ("m", "v"):
        _leafwise(jx["jax"], getattr(jst.opt, name), getattr(st.opt, name), 1e-5, name)


def _check_params(jx, case, grad_tol: float, what: str):
    """Every updated param within adamw_bound of the reference's, with the
    gradient's bound e = grad_tol * its leaf's largest value."""
    jax = jx["jax"]
    jst, st = case["jax_state"], case["state"]
    lr, t = case["jax_metrics"]["lr"], int(jst.opt.step)
    flip = total = 0
    grads = jax.tree.leaves(_np(case["jax_grads"], jax))
    ms, vs = jax.tree.leaves(_np(jst.opt.m, jax)), jax.tree.leaves(_np(jst.opt.v, jax))
    p0s = jax.tree.leaves(_np(case["jax_params"], jax))
    for (path, want, got), g, m, v, p0 in zip(_paired_leaves(jax, jst.params, st.params), grads,
                                              ms, vs, p0s):
        bound, lean = adamw_bound(p0, g, m, v, t, lr, grad_tol * np.abs(g).max())
        diff = np.abs(got - want)
        assert (diff <= bound).all(), \
            f"{what} {path}: {int((diff > bound).sum())} params beyond adamw_bound"
        flip += int((lean & (diff > 1e-3 * lr)).sum())
        total += diff.size
    worst = max(float(np.abs(g - w).max()) for _, w, g in
                _paired_leaves(jax, jst.params, st.params)) / lr
    print(f"{what}: updated params within adamw_bound; worst |difference| {worst:.3e} lr; "
          f"{flip} of {total} elements moved by more than 1e-3 lr on the flip allowance")


def test_train_step_f32_params(jx, f32_case):
    _check_params(jx, f32_case, 1e-5, "float32 step")


def test_train_step_bf16_within_the_reference_bound(jx, bf16_case):
    """bf16: the JAX package's own bound for two paths of one bf16 model,
    0.05 of the largest magnitude, for the loss, each gradient leaf and each
    moment leaf; the params within adamw_bound under that gradient bound."""
    c = bf16_case
    assert abs(c["metrics"]["loss"] - c["jax_metrics"]["loss"]) <= \
        0.05 * max(1.0, abs(c["jax_metrics"]["loss"]))
    worst = _leafwise(jx["jax"], c["jax_grads"], c["grads"], 0.05, "bf16 gradient")
    for name in ("m", "v"):
        _leafwise(jx["jax"], getattr(c["jax_state"].opt, name), getattr(c["state"].opt, name),
                  0.05, f"bf16 {name}")
    _check_params(jx, c, 0.05, "bf16 step")
    print(f"bf16 gradients: worst {worst:.3e} of the leaf's largest value")


# -- the port against itself, as the JAX package's own tests ------------------------
def test_microbatching_equivalence():
    """Four microbatches against one batch of 8 x 32 from the same init: the
    JAX package's test (tests/test_runtime.py) and its bounds (loss rtol
    1e-4, params atol 5e-5 / rtol 1e-3; its first step has lr 0), and the
    summed gradients, in float32 compute, within 1e-5 of each leaf's
    largest value."""
    cfg = configs.get(ARCH).reduced()
    batch = make_batch(0, 0, 8, 32, cfg.vocab_size, device="cpu")
    out = []
    for n in (1, 4):
        model = Model(cfg, device="cpu", trainable=True, remat=False)
        state = t_train.init_state(model, torch.Generator().manual_seed(0))
        state, met = t_train.make_train_step(model, n_microbatches=n)(state, batch)
        out.append((float(met["loss"]), state.params))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4)
    for a, b in zip(tree_flatten(out[0][1])[0], tree_flatten(out[1][1])[0], strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=5e-5, rtol=1e-3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_attention, "COMPUTE_DTYPE", torch.float32)
        mp.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
        model = Model(cfg, device="cpu", trainable=True)
        t_train.init_state(model, torch.Generator().manual_seed(3))
        got = [t_train.loss_and_grads(model, batch, n_microbatches=n) for n in (1, 4)]
    np.testing.assert_allclose(float(got[1][0]), float(got[0][0]), rtol=1e-5)
    for a, b in zip(tree_flatten(got[0][2])[0], tree_flatten(got[1][2])[0]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_chunked_cross_entropy_matches_unchunked_and_the_reference(jx):
    """In float32 compute: loss_fn_chunked (4 chunks of 8) against loss_fn in
    the port, loss within 1e-6 and each gradient leaf within 1e-5 of its
    largest value (the chunks' sums in another order); and against the JAX
    package's loss_fn_chunked at the same params, the loss within 1e-5."""
    jax, jnp = jx["jax"], jx["jnp"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx["attention"], "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(jx["layers"], "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(t_attention, "COMPUTE_DTYPE", torch.float32)
        mp.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
        cfg = jx["configs"].get(ARCH).reduced()
        jm = jx["Model"](cfg, remat=False)
        params = jm.init(jax.random.PRNGKey(5))
        jbatch = jx["make_batch"](1, 3, 2, 32, cfg.vocab_size)
        jl, (jnll, _) = jx["train"].loss_fn_chunked(jm, params, jbatch, seq_chunk=8)
        model = Model(configs.get(ARCH).reduced(), device="cpu", trainable=True)
        convert.model_params_from_numpy(model, _np(params, jax))
        batch = make_batch(1, 3, 2, 32, cfg.vocab_size, device="cpu")
        whole = t_train.loss_and_grads(model, batch)
        chunked = t_train.loss_and_grads(model, batch, seq_chunk=8)
    np.testing.assert_allclose(float(chunked[0]), float(whole[0]), rtol=1e-6)
    np.testing.assert_allclose(float(chunked[0]), float(jnll), rtol=1e-5)
    for a, b in zip(tree_flatten(whole[2])[0], tree_flatten(chunked[2])[0]):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_train_step_loss_decreases():
    """Twelve steps over two repeated batches lower the loss (the JAX
    package's test): base_lr 3e-3, 30 total steps."""
    cfg = configs.get(ARCH).reduced()
    model = Model(cfg, device="cpu", trainable=True, remat=True)
    state = t_train.init_state(model, torch.Generator().manual_seed(0))
    step = t_train.make_train_step(model, n_microbatches=1, base_lr=BASE_LR, total_steps=30)
    losses = []
    for s in range(12):
        state, m = step(state, make_batch(0, s % 2, 4, 32, cfg.vocab_size, device="cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(losses))


def test_launch_train_saves_and_resumes(tmp_path):
    """launch.train.main on the CPU: 6 steps uninterrupted; then 4 steps,
    a restart that resumes from the final checkpoint (step 4) and trains 2
    more. The resumed steps' losses equal the uninterrupted run's to the
    bit: the same state bits, the same batches, the same operations."""
    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
              "--log-every", "1", "--ckpt-every", "3"]
    full = launch_train.main(common + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    first = launch_train.main(common + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    again = launch_train.main(common + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    assert full["done"] == 6 and first["done"] == 4 and first["start"] == 0
    assert again["start"] == 4 and int(again["state"].step) == 6
    assert [first["losses"][s] for s in range(4)] == [full["losses"][s] for s in range(4)]
    assert again["losses"] == {4: full["losses"][4], 5: full["losses"][5]}
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == \
        ["step_00000003", "step_00000004", "step_00000006"]
    # the reference's labels: a periodic checkpoint holds the state after
    # label + 1 updates, the final one after label updates (ROADMAP.md 3)
    for label, updates in ((3, 4), (4, 4)):
        restored, _ = load_checkpoint(str(tmp_path / "b"), again["state"], step=label,
                                      device="cpu")
        assert int(restored.step) == updates


def test_training_is_dense_only_and_serving_stays_frozen():
    """Every registered arch builds trainable (float32 masters that require
    grad, every family: the name is from the slice that trained the dense
    family alone); --mesh 2x2 parses (every family trains tensor-parallel:
    tests/test_torch_tp_train*.py); jit_train_step(fsdp=True) builds on a
    stand-in (2, 2) mesh, each "embed" leaf's dim halved, and refuses a
    model not built on the mesh; a serving model keeps frozen bf16
    parameters and builds no graph."""
    for name in configs.all_names():
        model = Model(configs.get(name).reduced(), device="cpu", trainable=True)
        assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters()), \
            name
    assert not hasattr(Model, "TRAINING_WAITS_FOR")
    assert launch_train.check_mesh("2x2") == ((2, 2), ("data", "model"))
    from test_torch_tp_layers import _StandInMesh
    moe = Model(configs.get("deepseek-moe-16b").reduced(), device="cpu", trainable=True)
    with pytest.raises(ValueError, match="built on this mesh.*fsdp"):
        t_train.jit_train_step(moe, {"data": 2, "model": 1}, fsdp=True)
    moe = Model(configs.get("deepseek-moe-16b").reduced(), device="meta", trainable=True,
                mesh=_StandInMesh({"data": 2, "model": 2}, {"data": 1, "model": 0}))
    before = moe.top.embed.shape
    make, _ = t_train.jit_train_step(moe, moe.mesh, fsdp=True)
    assert callable(make({"tokens": (2, 8), "targets": (2, 8)}))
    assert moe.top.embed.shape == (before[0], before[1] // 2)
    cfg = configs.get(ARCH).reduced()
    served = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert all(not p.requires_grad for p in served.parameters())
    assert served.top.embed.dtype == torch.bfloat16
    logits, _, _ = served(make_batch(0, 0, 1, 16, cfg.vocab_size, device="cpu")["tokens"])
    assert logits.grad_fn is None
    trained = Model(cfg, device="cpu", trainable=True).init(torch.Generator().manual_seed(0))
    assert all(p.requires_grad and p.dtype == torch.float32 for p in trained.parameters())
    with pytest.raises(ValueError, match="trainable"):
        t_train.make_train_step(served)
