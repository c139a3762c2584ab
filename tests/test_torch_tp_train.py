"""Tensor-parallel training on the CPU: runtime.train.jit_train_step on
("data", "model") meshes of gloo ranks, the model built on the mesh
(Model(cfg, mesh=, trainable=True): each rank its float32 shard), against
the JAX package's unsharded make_train_step on Model(cfg, tp_size=M)
(GSPMD preserves values, so the unsharded program is the reference, as
tests/test_torch_train_dp.py and tests/test_torch_tp_serve.py argue).

The reduced qwen1.5-0.5b (grouped on 2 ranks; flat with Hp = 6 on 3, its
wk / wv / bk / bv replicated, so their gradients are per-rank partials,
and the MLP and vocab replicated) and recurrentgemma-9b (flat: K / V split
inside the one KV head on 2 ranks and gathered, replicated on 3; RG-LRU
channels split on 2, replicated on 3), on meshes (1, 2), (1, 3) and
(2, 2). Both packages start from the same state: the reference's
Model.init(PRNGKey(0)) parameters, moments drawn from a numpy seed (m
normal, v positive) and step counters at 100 (lr at its base), carried to
every rank by convert.train_state_from_numpy (each rank cuts its shard).

Bounds, as the unsharded tests hold them (tests/test_torch_train.py): in
float32 compute (COMPUTE_DTYPE float32 in both packages) the loss and the
global norm within 1e-5 relative, every gradient leaf, reassembled whole
from the ranks' shards, within 1e-5 of its largest |value|, and after each
of 2 steps every moment leaf within 1e-5 of its largest |value| and every
parameter within tests/test_torch_train_dp.py's summed adamw_bound; in bf16
one step of each arch on (1, 2), the loss and every gradient leaf within
0.05 of the largest magnitude. Every rank's parameter has exactly the local
shape its placement assigns. On (2, 2) ZeRO-1 on and off are bit-equal. On
(1, 1) the step on the mesh is bit-equal to make_train_step without one.
No step on any mesh raises torch's warning that a c10d collective has no
autograd kernel (the collectives are autograd Functions, models/tp.py).

On the (1, 2) group also: each Function's backward (reduce, enter, gather,
enter after gather, and the RG-LRU gates' reduce_take) against the
gradient of the same function of every rank's inputs taken in one process
(the sum of the ranks' vector-Jacobian products), and launch/train.py
--mesh 1x2 --reduced: 3 steps, and 2 steps resumed for a third, their
final checkpoints bit-equal, and the checkpoint (whole tensors) equal to
the ranks' shards put together and restored on no mesh.

Each mesh's ranks start once for the module (launch.mesh.spawn, a thread a
mesh); the JAX references run in this process meanwhile, each compiled
once.
"""
import importlib
import shutil
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train import _np, _paired_leaves  # noqa: E402
from test_torch_train_dp import _params_within_bound, _within  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_unflatten  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "recurrentgemma-9b")
MESHES = ((1, 2), (1, 3), (2, 2))
BATCH, SEQ = 4, 32
STEPS = (7, 8)                    # the batches of the two compared steps
START = 100                       # the carried step counters
MODEL_MODULES = ("layers", "attention", "blocks", "moe", "recurrent", "xlstm", "model")
NO_AUTOGRAD = ".*autograd kernel was not registered.*"
LAUNCH = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32", "--log-every", "1",
          "--ckpt-every", "100", "--mesh", "1x2"]


def _f32(mp, pkg: str, dtype) -> None:
    for name in MODEL_MODULES:
        mod = importlib.import_module(f"{pkg}.{name}")
        if hasattr(mod, "COMPUTE_DTYPE"):
            mp.setattr(mod, "COMPUTE_DTYPE", dtype)


def _detached(xs):
    return [x.detach().clone() for x in xs]


def _batches(cfg, n: int = 2):
    return [make_batch(0, s, BATCH, SEQ, cfg.vocab_size, device="cpu") for s in STEPS[:n]]


def _steps(mesh, arch: str, carried, n_steps: int, zero1s=(False,)) -> dict:
    """On this rank: the gradients (its shards) at the carried state, then
    n_steps of jit_train_step for each zero1, the state gathered whole
    (convert.train_state_whole) after each step."""
    from repro_torch.runtime import train as rt
    cfg = configs.get(arch).reduced()
    out: dict = {}
    for zero1 in zero1s:
        model = Model(cfg, device="cpu", trainable=True, mesh=mesh)
        state = convert.train_state_from_numpy(model, *carried)
        batches = _batches(cfg, n_steps)
        if not zero1:
            nll, _, g = rt._dp_loss_and_grads(model, rt._DataParallel(mesh), batches[0], 1, 0)
            out.update(nll=float(nll), grads=_detached(tree_flatten(g)[0]),
                       slices=model.param_slices(),
                       shapes=[tuple(p.shape) for p in tree_flatten(model.param_tree())[0]])
        step = rt.jit_train_step(model, mesh, zero1=zero1)[0](
            {k: v.shape for k, v in batches[0].items()})
        reads = []
        for b in batches:
            state, met = step(state, b)
            whole = convert.train_state_whole(model, state)
            reads.append(dict(params=_detached(tree_flatten(whole.params)[0]),
                              m=_detached(tree_flatten(whole.opt.m)[0]),
                              v=_detached(tree_flatten(whole.opt.v)[0]),
                              metrics={k: float(x) for k, x in met.items()},
                              step=int(state.step)))
        out[f"zero1={zero1}"] = reads
    return out


def _one_device(mesh) -> dict:
    """On a (1, 1) mesh: 2 steps of each arch (bf16) on the mesh against
    make_train_step on a model without one, from the same init: are the
    params, moments and metrics bit-equal?"""
    from repro_torch.runtime import train as rt
    out = {}
    for arch in ARCHS:
        cfg = configs.get(arch).reduced()
        runs = []
        for on_mesh in (False, True):
            model = Model(cfg, device="cpu", trainable=True, mesh=mesh if on_mesh else None)
            state = rt.init_state(model, torch.Generator().manual_seed(0))
            state = state._replace(step=torch.tensor(START, dtype=torch.int32))
            batches = _batches(cfg)
            step = (rt.jit_train_step(model, mesh)[0]({k: v.shape for k, v in
                                                        batches[0].items()})
                    if on_mesh else rt.make_train_step(model))
            mets = []
            for b in batches:
                state, met = step(state, b)
                mets.append({k: float(x) for k, x in met.items()})
            runs.append((_detached(tree_flatten(state)[0]), mets))
        (a, ma), (b, mb) = runs
        out[arch] = ma == mb and all(torch.equal(x, y) for x, y in zip(a, b, strict=True))
    return out


def _function_checks(mesh) -> dict:
    """Each autograd Function's input gradient on this rank against the
    gradient of the same function of all ranks' inputs in one process (the
    sum over the ranks of their vector-Jacobian products): the worst
    |difference| by function."""
    from repro_torch.models import tp as ttp
    tp = ttp.TP.on_mesh(mesh, {})
    n, r = tp.size, tp.rank
    gen = torch.Generator().manual_seed(5)
    xs = torch.randn(n, 3, 4, generator=gen, dtype=torch.float64)     # each rank's input
    gs = torch.randn(n, 3, 4, generator=gen, dtype=torch.float64)     # each rank's cotangent
    gw = torch.randn(n, 3, 4 * n, generator=gen, dtype=torch.float64)
    out = {}

    def grad_of(f, x):
        x = x.clone().requires_grad_(True)
        f(x).backward()
        return x.grad

    # reduce: y = sum of the ranks' x, used alike on every rank (gs[0])
    want = grad_of(lambda x: (x.sum(0) * gs[0]).sum(), xs)[r]
    got = grad_of(lambda x: (tp.reduce(x) * gs[0]).sum(), xs[r])
    out["reduce"] = float((got - want).abs().max())
    # enter: x alike on every rank, each rank's own use of it (gs[r])
    want = grad_of(lambda x: sum((x * gs[k]).sum() for k in range(n)), xs[0])
    got = grad_of(lambda x: (tp.enter(x) * gs[r]).sum(), xs[0])
    out["enter"] = float((got - want).abs().max())
    # gather: the ranks' slices made whole, used alike (gw[0])
    want = grad_of(lambda x: (torch.cat(list(x), -1) * gw[0]).sum(), xs)[r]
    got = grad_of(lambda x: (tp.gather(x, -1) * gw[0]).sum(), xs[r])
    out["gather"] = float((got - want).abs().max())
    # enter after gather (K / V split inside a head): each rank its own use
    want = grad_of(lambda x: sum((torch.cat(list(x), -1) * gw[k]).sum()
                                 for k in range(n)), xs)[r]
    got = grad_of(lambda x: (tp.enter(tp.gather(x, -1)) * gw[r]).sum(), xs[r])
    out["enter(gather)"] = float((got - want).abs().max())
    # reduce_take: partial products summed, each rank keeping its columns
    ps = torch.randn(n, 2, 3, 4 * n, generator=gen, dtype=torch.float64)
    cs = torch.randn(n, 2, 3, 4, generator=gen, dtype=torch.float64)

    def whole(p):
        total = p.sum(0)
        return sum((total[:, :, 4 * k:4 * (k + 1)] * cs[k]).sum() for k in range(n))
    want = grad_of(whole, ps)[r]

    def mine(p):
        a, b = tp.reduce_take([p[0], p[1]])
        return (a * cs[r][0]).sum() + (b * cs[r][1]).sum()
    got = grad_of(mine, ps[r])
    out["reduce_take"] = float((got - want).abs().max())
    return out


def _launch(tmp: str, mesh) -> dict:
    """launch/train.py --mesh 1x2 under this group: 3 steps into tmp/a; 2
    steps into tmp/b and a restart that trains the third. This rank's
    final state of run a as its shards, and where they sit."""
    full = launch_train.main(LAUNCH + ["--steps", "3", "--ckpt-dir", f"{tmp}/a"])
    first = launch_train.main(LAUNCH + ["--steps", "2", "--ckpt-dir", f"{tmp}/b"])
    again = launch_train.main(LAUNCH + ["--steps", "1", "--ckpt-dir", f"{tmp}/b"])
    model = Model(configs.get("qwen1.5-0.5b").reduced(), device="meta", trainable=True,
                  mesh=mesh)
    st = full["state"]
    return dict(losses=(full["losses"], first["losses"], again["start"], again["losses"]),
                shards=[_detached(tree_flatten(t)[0]) for t in (st.params, st.opt.m,
                                                                 st.opt.v)],
                slices=model.param_slices())


def train_rank(rank: int, shape: tuple, carried: dict, tmp: str) -> None:
    """One rank of a ``shape`` mesh: what the module's tests read, written to
    tmp/rank<r>.pt."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp as ttp
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out = {"coord": ttp.mesh_coord(mesh)}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=NO_AUTOGRAD)
        if shape == (1, 1):
            out["one"] = _one_device(mesh)
        else:
            if shape == (1, 2):
                out["launch"] = _launch(tmp, mesh)
                out["functions"] = _function_checks(mesh)
            for f32 in ((True, False) if shape == (1, 2) else (True,)):
                with pytest.MonkeyPatch.context() as mp:
                    if f32:
                        _f32(mp, "repro_torch.models", torch.float32)
                    for arch in ARCHS:
                        out[f32, arch] = _steps(mesh, arch, carried[f32, arch, shape[1]],
                                                2 if f32 else 1,
                                                (False, True) if shape == (2, 2) else (False,))
    torch.save(out, f"{tmp}/rank{rank}.pt")


def _carried(jax, jm):
    """The state both packages start from: the reference's init params,
    moments from a numpy seed, step counters at START (numpy trees)."""
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    m = jax.tree.map(lambda p: (1e-3 * rng.standard_normal(p.shape)).astype(np.float32),
                     params)
    v = jax.tree.map(lambda p: (1e-4 * rng.uniform(0.5, 1.5, p.shape)).astype(np.float32),
                     params)
    return params, m, v, np.int32(START), np.int32(START)


def _reference(jx, jm, carried, n_steps: int) -> list:
    """n_steps of the reference's make_train_step from ``carried``, each
    with the loss and gradients at its starting params."""
    jax, jnp, jtrain = jx["jax"], jx["jnp"], jx["train"]
    from repro.optim.adamw import AdamWState
    train_step = jtrain.make_train_step(jm)

    @jax.jit
    def step_and_grads(st, b):
        (_, (loss, _)), grads = jax.value_and_grad(
            lambda p: jtrain.loss_fn(jm, p, b), has_aux=True)(st.params)
        return train_step(st, b), (loss, grads)

    params, m, v, opt_step, step = jax.tree.map(jnp.asarray, carried)
    st = jtrain.TrainState(params=params, opt=AdamWState(step=opt_step, m=m, v=v), step=step)
    refs = []
    for s in STEPS[:n_steps]:
        before = st
        (st, met), (loss, grads) = step_and_grads(
            st, jx["make_batch"](0, s, BATCH, SEQ, jm.cfg.vocab_size))
        refs.append(dict(before=before, state=st, grads=grads, loss=float(loss),
                         metrics={k: float(x) for k, x in met.items()}))
    return refs


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
    jx = dict(jax=jax, jnp=jnp, train=jtrain, make_batch=jmake_batch)
    models = {(f32, arch, m): JModel(jconfigs.get(arch).reduced(), remat=True,
                                     moe_capacity=2.0, tp_size=m)
              for f32 in (True, False) for arch in ARCHS for m in (2, 3)
              if f32 or m == 2}
    carried = {key: _carried(jax, jm) for key, jm in models.items()}
    tmp = tmp_path_factory.mktemp("tp_train")
    failed = []

    def ranks(shape):
        d = tmp / "x".join(map(str, shape))
        d.mkdir()
        try:
            tmesh.spawn(train_rank, shape[0] * shape[1], (shape, carried, str(d)),
                        init_method=f"file://{d / 'rendezvous'}", device="cpu")
        except Exception as e:  # surfaced below
            failed.append(e)
    shapes = ((1, 1),) + MESHES
    threads = [threading.Thread(target=ranks, args=(shape,)) for shape in shapes]
    for t in threads:
        t.start()
    refs = {}
    for f32 in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if f32:
                _f32(mp, "repro.models", jnp.float32)
            for key, jm in models.items():
                if key[0] == f32:
                    refs[key] = _reference(jx, jm, carried[key], 2 if f32 else 1)
    for t in threads:
        t.join(timeout=240)
        assert not t.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    got = {shape: [torch.load(tmp / "x".join(map(str, shape)) / f"rank{r}.pt",
                              weights_only=False) for r in range(shape[0] * shape[1])]
           for shape in shapes}
    return dict(jax=jax, refs=refs, ranks=got, tmp=tmp)


def _port_tree(arch: str, m: int, leaves: list):
    """Whole leaves (in tree_flatten order) as the tree of the unsharded
    port model of the same layout."""
    model = Model(configs.get(arch).reduced(), device="meta", trainable=True, tp_size=m)
    return tree_unflatten(tree_flatten(model.param_tree())[1], leaves)


def _assembled(ranks: list, f32: bool, arch: str, m: int):
    """The gradient reassembled whole from every rank's shard (each written
    at the slice its placement assigns); no element left unwritten."""
    model = Model(configs.get(arch).reduced(), device="meta", trainable=True, tp_size=m)
    leaves = [torch.full(tuple(x.shape), float("nan"))
              for x in tree_flatten(model.param_shapes())[0]]
    for rk in ranks:
        for whole, g, cut in zip(leaves, rk[f32, arch]["grads"], rk[f32, arch]["slices"],
                                 strict=True):
            whole[cut] = g
    assert not any(bool(torch.isnan(x).any()) for x in leaves)
    return _port_tree(arch, m, leaves)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_float32_gradients_match_the_unsharded_reference(case, shape, arch):
    """The loss, and every gradient leaf reassembled whole, within 1e-5."""
    ref = case["refs"][True, arch, shape[1]][0]
    ranks = case["ranks"][shape]
    worst = _within(case["jax"], ref["grads"], _assembled(ranks, True, arch, shape[1]), 1e-5,
                    f"{arch} {shape} gradient")
    for rk in ranks:
        np.testing.assert_allclose(rk[True, arch]["nll"], ref["loss"], rtol=1e-5)
    print(f"{arch} on {shape}: float32 gradients within {worst:.2e} of each leaf's largest "
          "value")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_float32_steps_match_the_unsharded_reference(case, shape, arch):
    """Two steps: the loss, the global norm and the learning rate, the moments
    and the parameters (gathered whole) against the reference's, on every
    rank."""
    jax, refs = case["jax"], case["refs"][True, arch, shape[1]]
    for rk in case["ranks"][shape]:
        for i, (ref, got) in enumerate(zip(refs, rk[True, arch]["zero1=False"], strict=True)):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5)
            assert got["metrics"]["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
            assert got["step"] == START + 1 + i
            for name in ("m", "v"):
                _within(jax, getattr(ref["state"].opt, name),
                        _port_tree(arch, shape[1], got[name]), 1e-5, f"{arch} {shape} step {i} "
                        f"{name}")
            _params_within_bound(jax, refs[:i + 1], _port_tree(arch, shape[1], got["params"]),
                                 f"{arch} {shape} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_on_two_ranks_within_the_reference_bound(case, arch):
    """bf16: the loss and every gradient leaf within 0.05 of the largest
    magnitude (the JAX package's bound for two paths of one bf16 model)."""
    ref = case["refs"][False, arch, 2][0]
    got = case["ranks"][1, 2]
    worst = _within(case["jax"], ref["grads"], _assembled(got, False, arch, 2), 0.05,
                    f"{arch} bf16 gradient")
    for rk in got:
        loss = rk[False, arch]["zero1=False"][0]["metrics"]["loss"]
        assert abs(loss - ref["metrics"]["loss"]) <= 0.05 * max(1.0, abs(ref["metrics"]["loss"]))
    print(f"{arch} bf16 on (1, 2): gradients within {worst:.3e} of each leaf's largest value")


@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_holds_its_placements_shard(case, shape):
    from repro_torch.runtime import sharding
    sizes = {"data": shape[0], "model": shape[1]}
    for arch in ARCHS:
        model = Model(configs.get(arch).reduced(), device="meta", trainable=True,
                      tp_size=shape[1])
        whole = model.param_shapes()
        want = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
            sharding.sharding_leaves(sharding.tree_shardings(sizes, model.specs(), whole)),
            tree_flatten(whole)[0], strict=True)]
        for rk in case["ranks"][shape]:
            assert rk[True, arch]["shapes"] == want, (arch, shape)


def test_zero1_on_and_off_are_bit_equal_on_two_by_two(case):
    for rk in case["ranks"][2, 2]:
        for arch in ARCHS:
            off, on = rk[True, arch]["zero1=False"], rk[True, arch]["zero1=True"]
            for a, b in zip(off, on, strict=True):
                assert a["metrics"] == b["metrics"]
                for name in ("params", "m", "v"):
                    assert all(torch.equal(x, y) for x, y in zip(a[name], b[name],
                                                                  strict=True)), (arch, name)


def test_a_one_device_mesh_is_bit_equal_and_no_step_warns(case):
    """On (1, 1) both archs' steps on the mesh equal make_train_step's to the
    bit; every mesh's ranks ran their steps with the missing-autograd
    warning turned into an error (a rank that raised would have failed the
    fixture)."""
    (rk,) = case["ranks"][1, 1]
    assert rk["one"] == {arch: True for arch in ARCHS}
    assert all(len(case["ranks"][shape]) == shape[0] * shape[1] for shape in MESHES)


@pytest.mark.parametrize("fn", ["reduce", "enter", "gather", "enter(gather)", "reduce_take"])
def test_each_functions_backward_is_the_sum_of_the_ranks_vjps(case, fn):
    for rk in case["ranks"][1, 2]:
        assert rk["functions"][fn] <= 1e-12, (fn, rk["functions"])


def test_launch_on_a_model_axis_resumes_and_restores_on_no_mesh(case, tmp_path):
    """--mesh 1x2: the run of 3 steps and the run of 2 resumed for a third
    log the same losses and leave the same final checkpoint, every leaf
    bit-equal; that checkpoint holds whole tensors equal to the ranks'
    shards put together, restores on no mesh with every leaf bit-equal,
    and the entry point on one device resumes from it."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.runtime import train as rt
    ranks = case["ranks"][1, 2]
    (full, first, start, again) = ranks[0]["launch"]["losses"]
    assert start == 2 and again == {2: full[2]}
    assert [first[s] for s in range(2)] == [full[s] for s in range(2)]
    model = Model(configs.get("qwen1.5-0.5b").reduced(), device="cpu", trainable=True)
    like = rt.init_state(model, torch.Generator().manual_seed(0))
    base = case["tmp"] / "1x2"
    a, label = load_checkpoint(str(base / "a"), like, device="cpu")
    b, _ = load_checkpoint(str(base / "b"), like, step=label, device="cpu")
    assert label == 3 and int(a.step) == 3
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))
    for k, tree in enumerate((a.params, a.opt.m, a.opt.v)):
        for rk in ranks:
            for whole, shard, cut in zip(tree_flatten(tree)[0], rk["launch"]["shards"][k],
                                         rk["launch"]["slices"], strict=True):
                assert torch.equal(whole[cut], shard)
    shutil.copytree(base / "a", tmp_path / "a")
    more = launch_train.main(LAUNCH[:-2] + ["--steps", "1", "--ckpt-dir", str(tmp_path / "a")])
    assert more["start"] == 3 and int(more["state"].step) == 4
    assert np.isfinite(more["losses"][3])
