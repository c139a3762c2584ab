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
def _step_case(jx, dtype: str) -> dict:
    """The reference state after two steps of make_train_step (base_lr 3e-3)
    on make_batch(0, s, 4, 32), its step counters set to 100 (the end of the
    warmup: lr = base_lr, bias corrections near 1), then one more step on
    make_batch(0, 7, 4, 32) in both packages from the same bits, with
    COMPUTE_DTYPE float32 in both when dtype is "float32". Returns the
    readings as numpy and port trees."""
    jax, jnp = jx["jax"], jx["jnp"]
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "float32":
            mp.setattr(jx["attention"], "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(jx["layers"], "COMPUTE_DTYPE", jnp.float32)
            mp.setattr(t_attention, "COMPUTE_DTYPE", torch.float32)
            mp.setattr(t_layers, "COMPUTE_DTYPE", torch.float32)
        cfg = jx["configs"].get(ARCH).reduced()
        jm = jx["Model"](cfg, remat=True)
        jstep = jax.jit(jx["train"].make_train_step(jm, base_lr=BASE_LR, total_steps=300))
        st = jx["train"].init_state(jm, jax.random.PRNGKey(0))
        for s in range(2):
            st, _ = jstep(st, jx["make_batch"](0, s, 4, 32, cfg.vocab_size))
        st = st._replace(step=jnp.int32(100), opt=st.opt._replace(step=jnp.int32(100)))
        jbatch = jx["make_batch"](0, 7, 4, 32, cfg.vocab_size)
        (_, (jloss, _)), jgrads = jax.value_and_grad(
            lambda p: jx["train"].loss_fn(jm, p, jbatch), has_aux=True)(st.params)
        st2, jmet = jstep(st, jbatch)

        model = Model(configs.get(ARCH).reduced(), device="cpu", trainable=True)
        state = convert.train_state_from_numpy(
            model, _np(st.params, jax), _np(st.opt.m, jax), _np(st.opt.v, jax),
            np.asarray(st.opt.step), np.asarray(st.step))
        batch = make_batch(0, 7, 4, 32, cfg.vocab_size, device="cpu")
        _, _, grads = t_train.loss_and_grads(model, batch)
        step = t_train.make_train_step(model, base_lr=BASE_LR, total_steps=300)
        state2, met = step(state, batch)
    return dict(jax_params=st.params, jax_grads=jgrads, jax_loss=float(jloss), jax_state=st2,
                jax_metrics={k: float(v) for k, v in jmet.items()}, grads=grads, state=state2,
                metrics={k: float(v) for k, v in met.items()})


@pytest.fixture(scope="module")
def f32_case(jx):
    return _step_case(jx, "float32")


@pytest.fixture(scope="module")
def bf16_case(jx):
    return _step_case(jx, "bfloat16")


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
    """A trainable model of another family raises, naming what it waits
    for; a mesh of more than one device raises; a serving model keeps
    frozen bf16 parameters and builds no graph."""
    for name, words in (("recurrentgemma-9b", "rg_lru backward"),
                        ("deepseek-moe-16b", "moe family"),
                        ("xlstm-125m", "ssm family")):
        with pytest.raises(NotImplementedError, match=words):
            Model(configs.get(name).reduced(), device="cpu", trainable=True)
    with pytest.raises(NotImplementedError, match="runtime/sharding"):
        launch_train.check_mesh("2x1")
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
