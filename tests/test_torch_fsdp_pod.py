"""FSDP and the pod axis on the CPU: runtime.train.jit_train_step on 4 gloo
ranks, the model built on the mesh (Model(cfg, mesh=, trainable=True)),
the reduced qwen1.5-0.5b and deepseek-moe-16b in float32 compute against
the JAX package's unsharded make_train_step on Model(cfg, tp_size=2)
(GSPMD preserves values, so the unsharded program is the reference, as
tests/test_torch_train_dp.py argues):

  * (2, 2) ("data", "model") with FSDP (every "embed" dim split over
    "data"), ZeRO-1 off and on;
  * (2, 1, 2) ("pod", "data", "model") without FSDP: the pod axis alone
    splits the batch (the data-parallel group is the mesh's "pod" group);
  * (1, 2, 2) with FSDP over ("pod", "data");
  * (2, 2, 1) with FSDP, qwen1.5-0.5b only: pod and data both above 1, so
    the data-parallel group is one dist.new_group a model index.

Both packages start from the same state: the reference's
Model.init(PRNGKey(0)) parameters, moments drawn from a numpy seed and
step counters at 100 (tests/test_torch_tp_train.py's _carried), carried
to every rank by convert.train_state_from_numpy after jit_train_step has
sharded the model (each rank cuts its FSDP shard). Bounds, as the tensor-
parallel training tests hold them: the loss, the MoE aux loss and the
global norm within 1e-5 relative; every gradient leaf, reassembled whole
from the ranks' shards, within 1e-5 of its largest |value|; after each of
2 steps every moment leaf (gathered whole, convert.train_state_whole)
within 1e-5 and every parameter within tests/test_torch_train_dp.py's
summed adamw_bound; each MoE layer's dropped slots equal to the
reference's (read off its router, at capacity 1.25 over the whole batch).
Each rank holds, between steps, exactly the local shape
tree_shardings(fsdp=True) assigns of every parameter and moment (its
"embed" dims halved where FSDP splits them); ZeRO-1 on and off are
bit-equal.

On the same 4 ranks: launch/train.py --mesh 2x1x2 --reduced, 3 steps, and
2 steps resumed for a third, their final checkpoints bit-equal, and that
whole checkpoint restored on no mesh.

The ranks start once for the module (launch.mesh.spawn, a file://
rendezvous under the module's temporary directory); the two JAX
references (one a model: every mesh's model axis is 2) run in this
process meanwhile, each compiled once.
"""
import importlib
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tp_serve import _dropped  # noqa: E402
from test_torch_tp_train import NO_AUTOGRAD, START, _carried, _detached, _f32  # noqa: E402
from test_torch_tp_train_moe_xlstm import (  # noqa: E402
    CAPACITY,
    REF_MODULES,
    batches,
    reference,
    reference_routes,
)
from test_torch_train_dp import _params_within_bound, _within  # noqa: E402

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core.types import tree_flatten, tree_unflatten  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402

WORLD = 4
ARCHS = ("qwen1.5-0.5b", "deepseek-moe-16b")
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# mesh -> (fsdp, the archs it steps, whether ZeRO-1 runs on as well)
MESHES = {
    (2, 2): (True, ARCHS, True),
    (2, 1, 2): (False, ARCHS, False),
    (1, 2, 2): (True, ARCHS, False),
    (2, 2, 1): (True, ("qwen1.5-0.5b",), False),
}
PAIRS = [(shape, arch) for shape, (_, archs, _) in MESHES.items() for arch in archs]
LAUNCH = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32", "--log-every", "1",
          "--ckpt-every", "100", "--mesh", "2x1x2"]


def _sizes(shape) -> dict:
    return dict(zip(AXES[len(shape)], shape))


def steps_on(mesh, shape, arch: str, carried, fsdp: bool, zero1s) -> dict:
    """On this rank: the loss, aux, dropped slots and gradients (its shards)
    at the carried state, then 2 steps of jit_train_step for each zero1,
    the state gathered whole after each step; the local shapes of the
    params and moments between the steps."""
    from repro_torch.models import moe
    from repro_torch.runtime import train as rt
    cfg = configs.get(arch).reduced()
    out: dict = {}
    for zero1 in zero1s:
        model = Model(cfg, device="cpu", trainable=True, mesh=mesh, moe_capacity=CAPACITY)
        make = rt.jit_train_step(model, mesh, zero1=zero1, fsdp=fsdp)[0]
        state = convert.train_state_from_numpy(model, *carried)
        bs = batches(cfg)
        if not zero1:
            with moe.drop_log() as log:
                nll, aux, g = rt._dp_loss_and_grads(model, rt._DataParallel(mesh), bs[0], 1, 0)
            out.update(nll=float(nll), aux=float(aux), drops=[int(d) for d in log],
                       grads=_detached(tree_flatten(g)[0]), slices=model.param_slices())
        step = make({k: v.shape for k, v in bs[0].items()})
        reads = []
        for b in bs:
            state, met = step(state, b)
            out["local", zero1] = [tuple(x.to_local().shape if hasattr(x, "to_local")
                                         else x.shape) for x in tree_flatten(
                (state.params, state.opt.m, state.opt.v))[0]]
            whole = convert.train_state_whole(model, state)
            reads.append(dict(params=_detached(tree_flatten(whole.params)[0]),
                              m=_detached(tree_flatten(whole.opt.m)[0]),
                              v=_detached(tree_flatten(whole.opt.v)[0]),
                              metrics={k: float(x) for k, x in met.items()},
                              step=int(state.step)))
        out[f"zero1={zero1}"] = reads
    return out


def launch_runs(tmp: str) -> dict:
    """launch/train.py --mesh 2x1x2 under this group: 3 steps into tmp/a; 2
    steps into tmp/b and a restart that trains the third."""
    full = launch_train.main(LAUNCH + ["--steps", "3", "--ckpt-dir", f"{tmp}/a"])
    first = launch_train.main(LAUNCH + ["--steps", "2", "--ckpt-dir", f"{tmp}/b"])
    again = launch_train.main(LAUNCH + ["--steps", "1", "--ckpt-dir", f"{tmp}/b"])
    return dict(losses=(full["losses"], first["losses"], again["start"], again["losses"]))


def fsdp_rank(rank: int, carried: dict, tmp: str) -> None:
    """One of the 4 ranks: every mesh's cases, then the entry point; what the
    tests read, written to tmp/rank<r>.pt."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp as ttp
    out: dict = {}
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=NO_AUTOGRAD)
        out["launch"] = launch_runs(tmp)
        with pytest.MonkeyPatch.context() as mp:
            _f32(mp, "repro_torch.models", torch.float32)
            for shape, (fsdp, archs, zero1) in MESHES.items():
                mesh = make_mesh(shape, AXES[len(shape)], device="cpu")
                out[shape, "coord"] = ttp.mesh_coord(mesh)
                for arch in archs:
                    t0 = time.monotonic()
                    out[shape, arch] = steps_on(mesh, shape, arch, carried[arch], fsdp,
                                                (False, True) if zero1 else (False,))
                    out[shape, arch]["seconds"] = time.monotonic() - t0
    torch.save(out, f"{tmp}/rank{rank}.pt")


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
    jms = {arch: JModel(jconfigs.get(arch).reduced(), remat=True, moe_capacity=CAPACITY,
                        tp_size=2) for arch in ARCHS}
    carried = {arch: _carried(jax, jm) for arch, jm in jms.items()}
    tmp = tmp_path_factory.mktemp("fsdp_pod")
    failed = []

    def ranks():
        try:
            tmesh.spawn(fsdp_rank, WORLD, (carried, str(tmp)),
                        init_method=f"file://{tmp / 'rendezvous'}", device="cpu")
        except Exception as e:  # surfaced below
            failed.append(e)
    t0 = time.monotonic()
    thread = threading.Thread(target=ranks)
    thread.start()
    refs, routes = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for mod in REF_MODULES:
            mp.setattr(importlib.import_module(f"repro.models.{mod}"), "COMPUTE_DTYPE",
                       jnp.float32)
        for arch, jm in jms.items():
            refs[arch] = reference(jx, jm, carried[arch], 2)
            if jm.cfg.family == "moe":
                routes[arch] = reference_routes(jx, jm, carried[arch][0])
    t_refs = time.monotonic() - t0
    thread.join(timeout=300)
    assert not thread.is_alive(), "the ranks did not finish in 300 s"
    if failed:
        raise failed[0]
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    print(f"references {t_refs:.1f} s, ranks {time.monotonic() - t0:.1f} s; by case (rank 0): "
          + ", ".join(f"{k[0]} {k[1]} {v['seconds']:.1f} s" for k, v in got[0].items()
                      if isinstance(v, dict) and "seconds" in v))
    return dict(jax=jax, jcfgs=jconfigs, refs=refs, routes=routes, ranks=got, tmp=tmp)


def _unsharded(arch: str):
    return Model(configs.get(arch).reduced(), device="meta", trainable=True, tp_size=2)


def _port_tree(arch: str, leaves: list):
    """Whole leaves (in tree_flatten order) as the tree of the unsharded
    port model of the same layout."""
    return tree_unflatten(tree_flatten(_unsharded(arch).param_tree())[1], leaves)


def _assembled(ranks: list, shape, arch: str):
    """The gradient reassembled whole from every rank's shard (each written
    at the slice its placement assigns); no element left unwritten."""
    leaves = [torch.full(tuple(x.shape), float("nan"))
              for x in tree_flatten(_unsharded(arch).param_shapes())[0]]
    for rk in ranks:
        got = rk[shape, arch]
        for whole, g, cut in zip(leaves, got["grads"], got["slices"], strict=True):
            whole[cut] = g
    assert not any(bool(torch.isnan(x).any()) for x in leaves)
    return _port_tree(arch, leaves)


@pytest.mark.parametrize("shape,arch", PAIRS)
def test_float32_gradients_match_the_unsharded_reference(case, shape, arch):
    """The loss and aux on every rank, every gradient leaf reassembled
    whole, and each MoE layer's dropped slots."""
    ref = case["refs"][arch][0]
    worst = _within(case["jax"], ref["grads"], _assembled(case["ranks"], shape, arch), 1e-5,
                    f"{arch} {shape} gradient")
    for rk in case["ranks"]:
        got = rk[shape, arch]
        np.testing.assert_allclose(got["nll"], ref["loss"], rtol=1e-5)
        assert abs(got["aux"] - ref["aux"]) <= 1e-5 * max(1.0, abs(ref["aux"]))
        if arch in case["routes"]:
            want = [_dropped(i, configs.get(arch).reduced()) for i in case["routes"][arch]]
            assert got["drops"] == want and sum(want) > 0, (got["drops"], want)
    print(f"{arch} on {shape}: float32 gradients within {worst:.2e} of each leaf's largest "
          "value")


@pytest.mark.parametrize("shape,arch", PAIRS)
def test_float32_steps_match_the_unsharded_reference(case, shape, arch):
    """Two steps: the loss, aux, global norm and learning rate, the moments
    and the parameters (gathered whole) against the reference's, on every
    rank, ZeRO-1 off and (on (2, 2)) on."""
    jax, refs = case["jax"], case["refs"][arch]
    for rk in case["ranks"]:
        for zero1 in (False, True) if MESHES[shape][2] else (False,):
            for i, (ref, got) in enumerate(zip(refs, rk[shape, arch][f"zero1={zero1}"],
                                               strict=True)):
                for k in ("loss", "grad_norm", "aux"):
                    assert abs(got["metrics"][k] - ref["metrics"][k]) <= \
                        1e-5 * max(1.0, abs(ref["metrics"][k])), (k, zero1, i)
                assert got["metrics"]["lr"] == pytest.approx(ref["metrics"]["lr"], rel=1e-6)
                assert got["step"] == START + 1 + i
                what = f"{arch} {shape} zero1={zero1} step {i}"
                for name in ("m", "v"):
                    _within(jax, getattr(ref["state"].opt, name),
                            _port_tree(arch, got[name]), 1e-5, f"{what} {name}")
                _params_within_bound(jax, refs[:i + 1], _port_tree(arch, got["params"]), what)


@pytest.mark.parametrize("shape,arch", PAIRS)
def test_each_rank_holds_its_fsdp_shard_between_steps(case, shape, arch):
    """Every parameter and moment leaf on every rank has exactly the local
    shape tree_shardings(fsdp=) assigns (ZeRO-1's widened moments, off
    FSDP leaves only, their slice of the widened dim too); under FSDP every
    leaf with an "embed" dim that divides holds its share of it."""
    from repro_torch.runtime import sharding
    from repro_torch.runtime.train import _zero1_shardings
    sizes = _sizes(shape)
    fsdp = MESHES[shape][0]
    model = _unsharded(arch)
    whole = model.param_shapes()
    p_shard = sharding.tree_shardings(sizes, model.specs(), whole, fsdp=fsdp)
    dp = sizes.get("pod", 1) * sizes["data"]
    for zero1 in (False, True) if MESHES[shape][2] else (False,):
        m_shard = _zero1_shardings(sizes, p_shard, whole) if zero1 else p_shard
        want = [sharding.local_shape(tuple(x.shape), sh.spec, sizes) for sh, x in zip(
            sharding.sharding_leaves(p_shard) + 2 * sharding.sharding_leaves(m_shard),
            3 * tree_flatten(whole)[0], strict=True)]
        for rk in case["ranks"]:
            assert rk[shape, arch]["local", zero1] == want, (shape, arch, zero1)
        if fsdp:
            embed = [(sh.spec, tuple(x.shape)) for sh, x, axes in zip(
                sharding.sharding_leaves(p_shard), tree_flatten(whole)[0],
                model._per_leaf(lambda d, spec, local: d.axes), strict=True)
                if "embed" in axes and x.shape[axes.index("embed")] % dp == 0]
            assert embed and all(any(e is not None and "data" in e for e in spec)
                                 for spec, _ in embed), (shape, arch)


def test_zero1_on_and_off_are_bit_equal_under_fsdp(case):
    for rk in case["ranks"]:
        for arch in ARCHS:
            got = rk[(2, 2), arch]
            for a, b in zip(got["zero1=False"], got["zero1=True"], strict=True):
                assert a["metrics"] == b["metrics"]
                for part in ("params", "m", "v"):
                    assert all(torch.equal(x, y) for x, y in zip(a[part], b[part],
                                                                  strict=True)), (arch, part)


def test_launch_on_a_pod_mesh_resumes_and_restores_on_no_mesh(case):
    """--mesh 2x1x2: the run of 3 steps and the run of 2 resumed for a third
    log the same losses and leave the same final checkpoint, every leaf
    bit-equal; that checkpoint (whole tensors) restores on no mesh."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.runtime import train as rt
    full, first, start, again = case["ranks"][0]["launch"]["losses"]
    assert start == 2 and again == {2: full[2]}
    assert [first[s] for s in range(2)] == [full[s] for s in range(2)]
    model = Model(configs.get("qwen1.5-0.5b").reduced(), device="cpu", trainable=True)
    like = rt.init_state(model, torch.Generator().manual_seed(0))
    a, label = load_checkpoint(str(case["tmp"] / "a"), like, device="cpu")
    b, _ = load_checkpoint(str(case["tmp"] / "b"), like, step=label, device="cpu")
    assert label == 3 and int(a.step) == 3
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0],
                                                  strict=True))
    assert all(tuple(x.shape) == tuple(y.shape) for x, y in zip(
        tree_flatten(a.params)[0], tree_flatten(model.param_tree())[0], strict=True))
    assert all(bool(torch.isfinite(x).all()) for x in tree_flatten(a.params)[0])
