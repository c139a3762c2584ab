"""The data-parallel train step on the CPU: runtime.train.jit_train_step on a
("data",) mesh of 2 gloo ranks, with ZeRO-1 on and off, and launch/train.py
--mesh 2x1, on the reduced qwen1.5-0.5b in float32 (COMPUTE_DTYPE float32
in both packages), against the JAX package's one-device make_train_step
from the same carried-over state and batches (GSPMD preserves values, and
the JAX package's own sharded step here would need forced host devices).

The same ranks also step the reduced deepseek-moe-16b on the (2,) mesh,
built on it, at the capacity factor 1.25 in float32: its MoE layers take
the whole batch's capacity and aux loss (the batch's two row blocks), so
the aux loss, the loss and every gradient leaf are held within 1e-5 of the
JAX package's unsharded step on the whole batch, the dropped slots equal
(read off the reference's router), and 2 steps within adamw_bound; and
launch/train.py --mesh 2x1 --arch deepseek-moe-16b builds its model on the
mesh, its first loss within 1e-5 of --mesh 1x1's. And every family steps
with FSDP on a (2, 1) ("data", "model") mesh (float32): the loss and aux
bit-equal to its step without FSDP on that mesh, the gradients before
clipping bit-equal at one microbatch (the gather's backward weighs and
sums the whole cotangent as the step without FSDP does) and within 1e-5 of
each leaf's largest value at two (each microbatch's slices summed in
another order).

Tolerances: each gradient leaf and moment leaf within 1e-5 of the leaf's
largest magnitude (the ranks' halves of the batch summed in another order
than one device sums them); the loss and the global norm within 1e-5
relative; the updated parameters within tests/test_torch_train.py's
adamw_bound under that gradient bound, summed over the steps taken (a
gradient that is zero up to rounding, such as the key bias's, which
softmax cancels, moves AdamW's normalised step by up to its learning rate:
the first-step trap of ROADMAP.md section 3; everywhere else the bound is
float32 rounding); ZeRO-1 on and off equal to the bit (AdamW is
elementwise); the entry point's losses on 2 ranks within 1e-5 of a
one-device run's.

The ranks start once for the module (launch.mesh.spawn, a file:// rendezvous
under the module's temporary directory); the JAX reference and the
one-device entry point run in this process meanwhile.
"""
import importlib
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import _np, _paired_leaves, adamw_bound, f32_compute  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_map  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.pshard import unshard  # noqa: E402
from repro_torch.runtime import train as t_train  # noqa: E402

ARCH = "qwen1.5-0.5b"
MOE_ARCH = "deepseek-moe-16b"
CAPACITY = 1.25                       # the default capacity factor, where slots drop
TP_ARCHS = ("qwen1.5-0.5b", "recurrentgemma-9b", "deepseek-moe-16b", "xlstm-125m",
            "llama-3.2-vision-11b", "whisper-small")
WORLD = 2
BATCH, SEQ = 4, 32
STEPS = (7, 8)                        # the batches of the two compared steps
MODEL_MODULES = ("layers", "attention", "blocks", "moe", "recurrent", "xlstm", "model")
LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
          "--log-every", "1", "--ckpt-every", "100"]
MOE_LAUNCH = ["--arch", MOE_ARCH] + LAUNCH[2:] + ["--steps", "1"]


def _port_f32() -> None:
    """COMPUTE_DTYPE float32 in the port's model modules (a rank's process)."""
    for name in MODEL_MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        if hasattr(mod, "COMPUTE_DTYPE"):
            mod.COMPUTE_DTYPE = torch.float32


def _copy(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def _tp_batch(cfg):
    """The model-axis step's batch, with the launcher's frontend."""
    return make_batch(0, 5, BATCH, SEQ, cfg.vocab_size, launch_train.frontend_shape(cfg, SEQ),
                      device="cpu")


def moe_case(mesh, carried) -> dict:
    """The reduced deepseek-moe-16b built on ``mesh`` at capacity CAPACITY
    (float32 compute): the loss, aux loss, dropped slots and gradients at
    the carried state, then two steps (the state whole after each)."""
    from repro_torch.models import moe
    cfg = configs.get(MOE_ARCH).reduced()
    model = Model(cfg, device="cpu", trainable=True, mesh=mesh, moe_capacity=CAPACITY)
    state = convert.train_state_from_numpy(model, *carried)
    batches = [make_batch(0, s, BATCH, SEQ, cfg.vocab_size, device="cpu") for s in STEPS]
    with moe.drop_log() as log:
        nll, aux, g = t_train._dp_loss_and_grads(model, t_train._DataParallel(mesh),
                                                 batches[0], 1, 0)
    out = dict(nll=float(nll), aux=float(aux), drops=[int(d) for d in log], grads=_copy(g),
               rows=model.tp.rows)
    step = t_train.jit_train_step(model, mesh)[0]({k: v.shape for k, v in batches[0].items()})
    out["steps"] = []
    for b in batches:
        state, met = step(state, b)
        out["steps"].append(dict(params=_copy(state.params), m=_copy(state.opt.m),
                                 v=_copy(state.opt.v), step=int(state.step),
                                 metrics={k: float(v) for k, v in met.items()}))
    return out


def fsdp_cases(mesh) -> dict:
    """Each family of TP_ARCHS on ``mesh`` ((2, 1)), without and with FSDP,
    from the same init: the gradient pass at one and at two microbatches
    (nll, aux, this rank's gradient leaves and their slices) and one
    step's metrics; each leaf's and moment's local shape after the FSDP
    step."""
    out = {}
    for arch in TP_ARCHS:
        cfg = configs.get(arch).reduced()
        b = _tp_batch(cfg)
        for fsdp in (False, True):
            model = Model(cfg, device="cpu", trainable=True, mesh=mesh)
            make = t_train.jit_train_step(model, mesh, fsdp=fsdp)[0]
            state = t_train.init_state(model, torch.Generator().manual_seed(0))
            dp = t_train._DataParallel(mesh)
            got = {}
            for mb in (1, 2):
                nll, aux, g = t_train._dp_loss_and_grads(model, dp, b, mb, 0)
                got[mb] = (float(nll), float(aux), _copy(tree_flatten(g)[0]))
            state, met = make({k: v.shape for k, v in b.items()})(state, b)
            got.update(metrics={k: float(met[k]) for k in ("loss", "aux")},
                       slices=model.param_slices(), data_dims=model.data_dims(),
                       shapes=[tuple(x.shape) for x in tree_flatten(
                           (state.params, state.opt.m))[0]])
            out[arch, fsdp] = got
    return out


def train_rank(rank: int, carried, carried_moe, tmp: str) -> None:
    """One rank: the data-parallel gradients at the carried state, then two
    steps with ZeRO-1 off and on; the entry point at --mesh 2x1 (1 step,
    then 1 more resumed from its checkpoint onto the mesh; deepseek-moe-16b
    for 1 step, its models' meshes recorded); the MoE case (moe_case) and
    every family with and without FSDP (fsdp_cases). Rank 0 writes what it
    read to tmp/train.pt."""
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get(ARCH).reduced()
    out: dict = {}
    launch = launch_train.main(LAUNCH + ["--steps", "1", "--mesh", "2x1",
                                         "--ckpt-dir", f"{tmp}/ckpt"])
    again = launch_train.main(LAUNCH + ["--steps", "1", "--mesh", "2x1",
                                        "--ckpt-dir", f"{tmp}/ckpt"])
    out["launch"] = (launch["losses"], again["start"], again["losses"])
    built = []

    class Recorded(Model):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self.tp.rows if self.mesh is not None else None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(launch_train, "Model", Recorded)
        moe_launch = launch_train.main(MOE_LAUNCH + ["--mesh", "2x1",
                                                     "--ckpt-dir", f"{tmp}/moe"])
    out["moe launch"] = (moe_launch["losses"], built)
    _port_f32()
    out["fsdp"] = fsdp_cases(make_mesh((WORLD, 1), ("data", "model"), device="cpu"))
    tp_mesh = make_mesh((1, WORLD), ("data", "model"), device="cpu")
    for arch in TP_ARCHS:      # a model axis of 2: each rank its shard
        model = Model(configs.get(arch).reduced(), device="cpu", trainable=True, mesh=tp_mesh)
        state = t_train.init_state(model, torch.Generator().manual_seed(0))
        b = _tp_batch(model.cfg)
        step = t_train.jit_train_step(model, tp_mesh)[0]({k: v.shape for k, v in b.items()})
        out["tp", arch] = {k: float(v) for k, v in step(state, b)[1].items()}
    del tp_mesh
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
    out["moe"] = moe_case(mesh, carried_moe)
    for zero1 in (False, True):
        model = Model(cfg, device="cpu", trainable=True)
        state = convert.train_state_from_numpy(model, *carried)
        batches = [make_batch(0, s, BATCH, SEQ, cfg.vocab_size, device="cpu") for s in STEPS]
        if not zero1:
            nll, aux, g = t_train._dp_loss_and_grads(model, t_train._DataParallel(mesh),
                                                     batches[0], 1, 0)
            out["grads"] = _copy(g)
            out["nll"] = float(nll)
        make, shard = t_train.jit_train_step(model, mesh, zero1=zero1)
        step = make({k: v.shape for k, v in batches[0].items()})
        reads = []
        for b in batches:
            state, met = step(state, b)
            whole = unshard(state)
            reads.append(dict(params=_copy(whole.params), m=_copy(whole.opt.m),
                              v=_copy(whole.opt.v),
                              metrics={k: float(v) for k, v in met.items()},
                              step=int(whole.step)))
        out[f"zero1={zero1}"] = reads
        out[f"sharded={zero1}"] = sum(
            type(x).__name__ == "DTensor" for x in tree_flatten(state.opt.m)[0])
    if rank == 0:
        torch.save(out, f"{tmp}/train.pt")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.data import make_batch as jmake_batch
    from repro.models import Model as JModel
    from repro.runtime import train as jtrain
    from test_torch_tp_train import _carried
    from test_torch_tp_train_moe_xlstm import reference, reference_routes
    jx = dict(jax=jax, jnp=jnp, train=jtrain, make_batch=jmake_batch)
    tmp = tmp_path_factory.mktemp("train_dp")
    with pytest.MonkeyPatch.context() as mp:
        f32_compute(mp, jx)
        jmoe = JModel(jconfigs.get(MOE_ARCH).reduced(), remat=True, moe_capacity=CAPACITY)
        carried_moe = _carried(jax, jmoe)
        cfg = jconfigs.get(ARCH).reduced()
        jm = JModel(cfg, remat=True, moe_capacity=2.0)
        train_step = jtrain.make_train_step(jm)

        @jax.jit
        def step_and_grads(st, b):
            (_, (loss, _)), grads = jax.value_and_grad(
                lambda p: jtrain.loss_fn(jm, p, b), has_aux=True)(st.params)
            return train_step(st, b), (loss, grads)

        st = jtrain.init_state(jm, jax.random.PRNGKey(0))
        for s in range(2):
            (st, _), _ = step_and_grads(st, jmake_batch(0, s, BATCH, SEQ, cfg.vocab_size))
        st = st._replace(step=jnp.int32(100), opt=st.opt._replace(step=jnp.int32(100)))
        carried = (_np(st.params, jax), _np(st.opt.m, jax), _np(st.opt.v, jax),
                   np.asarray(st.opt.step), np.asarray(st.step))
        failed = []

        def ranks():
            try:
                tmesh.spawn(train_rank, WORLD, (carried, carried_moe, str(tmp)),
                            init_method=f"file://{tmp / 'rendezvous'}", device="cpu")
            except Exception as e:  # surfaced below
                failed.append(e)
        thread = threading.Thread(target=ranks)
        thread.start()
        refs = []
        for s in STEPS:
            before = st
            (st, met), (loss, grads) = step_and_grads(
                st, jmake_batch(0, s, BATCH, SEQ, cfg.vocab_size))
            refs.append(dict(before=before, state=st, grads=grads, loss=float(loss),
                             metrics={k: float(v) for k, v in met.items()}))
        moe_refs = reference(jx, jmoe, carried_moe, 2)
        moe_routes = reference_routes(jx, jmoe, carried_moe[0])
    one = launch_train.main(LAUNCH + ["--steps", "2", "--mesh", "1x1",
                                      "--ckpt-dir", str(tmp / "one")])
    moe_one = launch_train.main(MOE_LAUNCH + ["--mesh", "1x1", "--ckpt-dir", str(tmp / "moe1")])
    thread.join(timeout=240)
    assert not thread.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    return dict(jax=jax, refs=refs, one=one, moe_refs=moe_refs, moe_routes=moe_routes,
                moe_one=moe_one, jcfg=jmoe.cfg,
                ranks=torch.load(tmp / "train.pt", weights_only=False))


def _within(jax, ref_tree, port_tree, tol, what):
    """Each leaf within tol of its reference leaf's largest magnitude (the
    port's per-layer leaves restacked). Returns the worst reading."""
    worst = 0.0
    for path, w, g in _paired_leaves(jax, ref_tree, port_tree):
        assert g.shape == w.shape, (what, path)
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, err)
        assert err <= tol, f"{what} {path}: {err:.3e} of the leaf's largest value > {tol}"
    return worst


def test_dp_gradients_match_the_one_device_reference(case):
    worst = _within(case["jax"], case["refs"][0]["grads"], case["ranks"]["grads"], 1e-5,
                    "gradient")
    np.testing.assert_allclose(case["ranks"]["nll"], case["refs"][0]["loss"], rtol=1e-5)
    print(f"data-parallel gradients on {WORLD} ranks: worst {worst:.3e} of the leaf's "
          "largest value")


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("i", [0, 1])
def test_dp_step_matches_the_one_device_reference(case, zero1, i):
    """Step i of the data-parallel step: the loss, the global norm and the
    learning rate, each moment leaf and each updated parameter against the
    reference's one-device step from the same state."""
    jax = case["jax"]
    ref, got = case["refs"][i], case["ranks"][f"zero1={zero1}"][i]
    np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], ref["metrics"]["grad_norm"],
                               rtol=1e-5)
    assert got["metrics"]["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
    assert got["step"] == int(ref["state"].step) == 101 + i
    for name in ("m", "v"):
        _within(jax, getattr(ref["state"].opt, name), got[name], 1e-5, f"step {i} {name}")
    worst = _params_within_bound(jax, case["refs"][:i + 1], got["params"], f"step {i}")
    print(f"data-parallel step {i} zero1={zero1}: params within the summed adamw_bound; "
          f"worst |difference| {worst:.3e} lr")


def _params_within_bound(jax, refs, port_params, what):
    """Each updated parameter within the sum over the steps taken of
    adamw_bound (reference param, gradient and moments of each step, the
    gradient's bound 1e-5 of its leaf's largest value). Returns the worst
    |difference| in units of the learning rate."""
    bounds = None
    for ref in refs:
        st, t, lr = ref["state"], int(ref["state"].opt.step), ref["metrics"]["lr"]
        leaves = [jax.tree.leaves(_np(x, jax)) for x in
                  (ref["before"].params, ref["grads"], st.opt.m, st.opt.v)]
        step = [adamw_bound(p, g, m, v, t, lr, 1e-5 * np.abs(g).max())[0]
                for p, g, m, v in zip(*leaves)]
        bounds = step if bounds is None else [a + b for a, b in zip(bounds, step)]
    worst = 0.0
    for (path, want, got), bound in zip(_paired_leaves(jax, refs[-1]["state"].params,
                                                       port_params), bounds):
        diff = np.abs(got - want)
        assert (diff <= bound).all(), \
            f"{what} {path}: {int((diff > bound).sum())} params beyond the bound"
        worst = max(worst, float(diff.max()) / refs[-1]["metrics"]["lr"])
    return worst


def test_zero1_on_and_off_are_bit_equal(case):
    """Params, moments and metrics of both steps equal to the bit, and ZeRO-1
    did shard moments (DTensors split over the data axis)."""
    off, on = case["ranks"]["zero1=False"], case["ranks"]["zero1=True"]
    for a, b in zip(off, on):
        assert a["metrics"] == b["metrics"]
        for name in ("params", "m", "v"):
            la, lb = tree_flatten(a[name])[0], tree_flatten(b[name])[0]
            assert all(torch.equal(x, y) for x, y in zip(la, lb, strict=True)), name
    assert case["ranks"]["sharded=False"] == 0
    assert case["ranks"]["sharded=True"] > 0


def test_entry_point_on_two_ranks_matches_one_device(case):
    """launch/train.py --mesh 2x1 (each rank its half of the same global
    batch) in its default bf16: a step, then a restart resumed from its
    checkpoint onto the mesh for a second; the losses within 1e-5 of a
    --mesh 1x1 run's. (Further steps drift apart at bf16 rounding: AdamW's
    normalised step moves the elements whose bf16 gradient is rounding
    noise by up to the learning rate, 3.4e-5 of the loss at the fourth
    step here.)"""
    losses, start, again = case["ranks"]["launch"]
    one = case["one"]["losses"]
    assert start == 1 and sorted(again) == [1]
    got = {**losses, **again}
    assert sorted(got) == sorted(one) == [0, 1]
    for s in one:
        assert got[s] == pytest.approx(one[s], rel=1e-5), s
    assert all(np.isfinite(list(got.values())))


def test_moe_on_a_data_mesh_takes_the_whole_batchs_statistics(case):
    """The MoE fault of ROADMAP.md section 3, fixed: on the (2,) mesh the
    model built on it splits the batch into two row blocks, and the aux
    loss, the loss, every gradient leaf and each MoE layer's dropped slots
    are the whole batch's (the JAX package's unsharded step)."""
    from test_torch_tp_serve import _dropped
    got, ref = case["ranks"]["moe"], case["moe_refs"][0]
    assert got["rows"] == (WORLD, 0)
    assert abs(got["aux"] - ref["aux"]) <= 1e-5 * max(1.0, abs(ref["aux"])), \
        (got["aux"], ref["aux"])
    np.testing.assert_allclose(got["nll"], ref["loss"], rtol=1e-5)
    worst = _within(case["jax"], ref["grads"], got["grads"], 1e-5, "MoE gradient")
    want = [_dropped(i, case["jcfg"]) for i in case["moe_routes"]]
    assert got["drops"] == want and sum(want) > 0, (got["drops"], want)
    print(f"deepseek-moe-16b on ({WORLD},): aux {got['aux']!r} (reference {ref['aux']!r}), "
          f"gradients within {worst:.2e} of each leaf's largest value, drops {want}")


@pytest.mark.parametrize("i", [0, 1])
def test_moe_steps_on_a_data_mesh_match_the_unsharded_reference(case, i):
    jax, refs = case["jax"], case["moe_refs"]
    ref, got = refs[i], case["ranks"]["moe"]["steps"][i]
    for k in ("loss", "grad_norm", "aux"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5)
    assert got["step"] == int(ref["state"].step)
    for name in ("m", "v"):
        _within(jax, getattr(ref["state"].opt, name), got[name], 1e-5, f"MoE step {i} {name}")
    _params_within_bound(jax, refs[:i + 1], got["params"], f"MoE step {i}")


def test_moe_entry_point_builds_on_the_data_mesh(case):
    """launch/train.py --mesh 2x1 --arch deepseek-moe-16b: the model is built
    on the mesh (two row blocks), its loss within 1e-5 of --mesh 1x1's."""
    losses, built = case["ranks"]["moe launch"]
    assert built == [(WORLD, 0)]
    one = case["moe_one"]["losses"]
    assert sorted(losses) == sorted(one) == [0]
    assert losses[0] == pytest.approx(one[0], rel=1e-5)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_fsdp_on_two_by_one_matches_the_step_without_it(case, arch):
    """FSDP on (2, 1): loss and aux bit-equal; each gradient leaf (this
    rank's slice) bit-equal to the same slice without FSDP at one
    microbatch, within 1e-5 of the leaf's largest value at two; every
    "embed" leaf and its moments held as this rank's half."""
    off, on = case["ranks"]["fsdp"][arch, False], case["ranks"]["fsdp"][arch, True]
    assert on["metrics"] == off["metrics"]
    for mb in (1, 2):
        assert on[mb][:2] == off[mb][:2], mb
        for g, whole, cut in zip(on[mb][2], off[mb][2], on["slices"], strict=True):
            want = whole[cut]
            if mb == 1:
                assert torch.equal(g, want)
            else:
                scale = max(float(want.abs().max()), 1e-30)
                assert float((g - want).abs().max()) <= 1e-5 * scale
    split = [d >= 0 for d in on["data_dims"]]
    assert any(split) and not any(d >= 0 for d in off["data_dims"])
    n = len(split)
    for k, (a, b) in enumerate(zip(on["shapes"], off["shapes"], strict=True)):
        d = on["data_dims"][k % n]
        assert a == (b if d < 0 else b[:d] + (b[d] // WORLD,) + b[d + 1:]), (arch, k)


def test_a_model_axis_raises_naming_the_tp_item(case, monkeypatch):
    """Every family builds and steps on a ("data", "model") mesh of (1, 2)
    (in float32 compute: the loss, the aux loss and the global norm within
    1e-5 of the unsharded port's Model(cfg, tp_size=2) step from the same
    init; tests/test_torch_tp_train.py, test_torch_tp_train_moe_xlstm.py
    and test_torch_tp_train_vlm_audio.py hold them to the JAX package);
    jit_train_step(fsdp=True) builds on a stand-in ("data",) mesh; mesh
    axes beyond ("pod", "data", "model") still raise, and so do a MoE and
    an FSDP model not built on a mesh whose data axes exceed 1 (the test's
    name is from the slice that refused every model axis)."""
    for name in MODEL_MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        if hasattr(mod, "COMPUTE_DTYPE"):
            monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    for arch in TP_ARCHS:
        model = Model(configs.get(arch).reduced(), device="cpu", trainable=True, tp_size=2)
        state = t_train.init_state(model, torch.Generator().manual_seed(0))
        want = t_train.make_train_step(model)(state, _tp_batch(model.cfg))[1]
        got = case["ranks"]["tp", arch]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5)
        assert abs(got["aux"] - float(want["aux"])) <= 1e-5 * max(1.0, abs(float(want["aux"])))
    assert launch_train.check_mesh("2x2") == ((2, 2), ("data", "model"))
    assert launch_train.check_mesh("1x2x2") == ((1, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="1 to 3 axes"):
        launch_train.check_mesh("1x1x2x2")
    assert launch_train.check_mesh("2x1") == ((2, 1), ("data", "model"))
    assert launch_train.check_mesh("2x4x1") == ((2, 4, 1), ("pod", "data", "model"))
    moe = Model(configs.get("deepseek-moe-16b").reduced(), device="cpu", trainable=True)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        t_train.jit_train_step(moe, {"data": 1, "model": 1, "expert": 2})
    model = Model(configs.get(ARCH).reduced(), device="cpu", trainable=True)
    with pytest.raises(ValueError, match="built on this mesh"):
        t_train.jit_train_step(model, {"data": 1, "model": 2})
    with pytest.raises(ValueError, match="built on this mesh.*MoE"):
        t_train.jit_train_step(moe, {"data": 2})
    with pytest.raises(ValueError, match="built on this mesh.*fsdp"):
        t_train.jit_train_step(model, {"data": 2, "model": 1}, fsdp=True)
    from test_torch_tp_layers import _StandInMesh
    moe = Model(configs.get("deepseek-moe-16b").reduced(), device="meta", trainable=True,
                mesh=_StandInMesh({"data": 1}, {"data": 0}))
    make, shard = t_train.jit_train_step(moe, moe.mesh, fsdp=True)
    assert callable(make({"tokens": (2, 8), "targets": (2, 8)}))
    assert moe.fsdp is not None and moe.tp.rows == (1, 0)
