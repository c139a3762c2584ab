"""The data-parallel train step on the CPU: runtime.train.jit_train_step on a
("data",) mesh of 2 gloo ranks, with ZeRO-1 on and off, and launch/train.py
--mesh 2x1, on the reduced qwen1.5-0.5b in float32 (COMPUTE_DTYPE float32
in both packages), against the JAX package's one-device make_train_step
from the same carried-over state and batches (GSPMD preserves values, and
the JAX package's own sharded step here would need forced host devices).

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
WORLD = 2
BATCH, SEQ = 4, 32
STEPS = (7, 8)                        # the batches of the two compared steps
MODEL_MODULES = ("layers", "attention", "blocks", "moe", "recurrent", "xlstm", "model")
LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
          "--log-every", "1", "--ckpt-every", "100"]


def _port_f32() -> None:
    """COMPUTE_DTYPE float32 in the port's model modules (a rank's process)."""
    for name in MODEL_MODULES:
        mod = importlib.import_module(f"repro_torch.models.{name}")
        if hasattr(mod, "COMPUTE_DTYPE"):
            mod.COMPUTE_DTYPE = torch.float32


def _copy(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def train_rank(rank: int, carried, tmp: str) -> None:
    """One rank: the data-parallel gradients at the carried state, then two
    steps with ZeRO-1 off and on; the entry point at --mesh 2x1 (1 step,
    then 1 more resumed from its checkpoint onto the mesh). Rank 0 writes
    what it read to tmp/train.pt."""
    from repro_torch.launch.mesh import make_mesh
    cfg = configs.get(ARCH).reduced()
    out: dict = {}
    launch = launch_train.main(LAUNCH + ["--steps", "1", "--mesh", "2x1",
                                         "--ckpt-dir", f"{tmp}/ckpt"])
    again = launch_train.main(LAUNCH + ["--steps", "1", "--mesh", "2x1",
                                        "--ckpt-dir", f"{tmp}/ckpt"])
    out["launch"] = (launch["losses"], again["start"], again["losses"])
    _port_f32()
    mesh = make_mesh((WORLD,), ("data",), device="cpu")
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
    jx = dict(jnp=jnp)
    tmp = tmp_path_factory.mktemp("train_dp")
    with pytest.MonkeyPatch.context() as mp:
        f32_compute(mp, jx)
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
                tmesh.spawn(train_rank, WORLD, (carried, str(tmp)),
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
    one = launch_train.main(LAUNCH + ["--steps", "2", "--mesh", "1x1",
                                      "--ckpt-dir", str(tmp / "one")])
    thread.join(timeout=240)
    assert not thread.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    return dict(jax=jax, refs=refs, one=one, ranks=torch.load(tmp / "train.pt",
                                                              weights_only=False))


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


def test_a_model_axis_raises_naming_the_tp_item():
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        launch_train.check_mesh("2x2")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        launch_train.main(LAUNCH + ["--mesh", "1x2x2", "--steps", "1"])
    assert launch_train.check_mesh("2x1") == ((2, 1), ("data", "model"))
    assert launch_train.check_mesh("2x4x1") == ((2, 4, 1), ("pod", "data", "model"))
    model = Model(configs.get(ARCH).reduced(), device="cpu", trainable=True)
    mesh = {"data": 1, "model": 2}
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        t_train.jit_train_step(model, mesh)
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        t_train.jit_train_step(model, {"data": 1}, fsdp=True)
