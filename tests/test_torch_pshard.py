"""The port's sharding rules and meshes on torch.distributed, on the CPU:
pshard (spec_for, fleet_mesh, shard_fleet, replicate, constrain),
runtime/sharding (tree_shardings, batch_spec, cache_shardings),
runtime/train._zero1_shardings, launch/mesh, the elastic checkpoint restore
and optim.compressed_psum.

The rule functions read only axis sizes: the port's take a {axis: size}
mapping, the JAX package's a jax.sharding.AbstractMesh of the same shape,
and the specs must be equal. The port's parameters are per layer, so a
stage leaf's spec is the reference's spec of its stacked leaf without the
leading "layers" entry (ROADMAP.md section 3, differences by design); the
ZeRO-1 widening is held to the reference's function on the same per-layer
shardings and shapes. compressed_psum on 4 gloo ranks is held to the
reference's under jax.vmap(axis_name=...) to the bit (the same float32 adds
in the same order, rank by rank). The ranks start once for the module
(launch.mesh.spawn, a file:// rendezvous under its temporary directory).
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import compressed_psum, error_feedback_update  # noqa: E402
from repro_torch.pshard import (  # noqa: E402
    NamedSharding,
    constrain,
    fleet_axis,
    fleet_mesh,
    placements,
    replicate,
    shard_fleet,
    spec_for,
    unshard,
)
from repro_torch.runtime import sharding as shlib  # noqa: E402
from repro_torch.runtime.train import _zero1_shardings  # noqa: E402

WORLD = 4
MESHES = [(("data", "model"), (1, 4)), (("data", "model"), (2, 2)),
          (("pod", "data", "model"), (2, 2, 2)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)), (("data",), (3,))]
ARCHS = [("qwen1.5-0.5b", False), ("qwen1.5-0.5b", True), ("recurrentgemma-9b", True),
         ("deepseek-moe-16b", True), ("whisper-small", True)]
K_FRAC = 0.25
PSUM_SHAPE = (8, 16)
LAUNCH = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--batch", "4",
          "--seq", "16", "--log-every", "1", "--steps", "1"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests hold the port against the JAX package on the CPU")
    from jax.sharding import AbstractMesh

    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro.optim import compression as jcomp
    from repro.runtime import sharding as jsh
    from repro.runtime import train as jtrain

    def mesh(axes, shape):
        try:
            return AbstractMesh(shape, axes)
        except TypeError:   # older jax: ((name, size), ...)
            return AbstractMesh(tuple(zip(axes, shape)))
    return dict(jax=jax, mesh=mesh, configs=jconfigs, Model=JModel, sh=jsh, train=jtrain,
                comp=jcomp)


def _sizes(axes, shape):
    return dict(zip(axes, shape))


def _norm(spec) -> tuple:
    """A spec with each one-name tuple entry written as the name, as
    jax.sharding.PartitionSpec stores it (both mean that one axis)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


# -- the rules against the JAX package ---------------------------------------------------
CASES = [(("embed", "mlp"), (64, 128)), (("embed", "mlp"), (64, 6)),
         (("vocab", "embed"), (512, 64)), (("experts", "embed", "mlp"), (8, 64, 128)),
         (("batch", "seq", "embed"), (8, 128, 64)), (("batch", "kvseq", "kv_heads", None),
                                                      (4, 64, 8, 32)),
         (("lru", "lru_out"), (256, 256)), (("embed",), (30,)), (("fleet", None), (8, 3)),
         ((None, "heads", "qkv"), (2, 16, 48)), (("experts_row", "embed"), (6, 64))]


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("axes,shape", MESHES)
def test_spec_for_matches_the_reference(jx, axes, shape, fsdp):
    m = jx["mesh"](axes, shape)
    for logical, dims in CASES:
        want = tuple(jx["sh"].spec_for(m, logical, dims, fsdp=fsdp))
        assert _norm(spec_for(_sizes(axes, shape), logical, dims, fsdp=fsdp)) == \
            _norm(want), logical


def test_spec_for_cases_of_the_dryrun_test():
    """tests/test_sharding_dryrun.py's cases."""
    mesh = {"data": 1, "model": 4}
    assert spec_for(mesh, ("embed", "mlp"), (64, 128)) == (None, "model")
    assert spec_for(mesh, ("embed", "mlp"), (64, 6)) == (None, None)
    assert spec_for(mesh, ("vocab", "embed"), (512, 64)) == ("model", None)
    assert spec_for(mesh, ("experts", "embed", "mlp"), (8, 64, 128)) == ("model", None, None)
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert shlib.batch_spec(mesh, (8, 128)) == (("pod", "data"), None)
    assert shlib.batch_spec(mesh, (1, 128), seq_dim=1) == (None, "data")


@pytest.mark.parametrize("axes,shape", MESHES)
def test_batch_spec_matches_the_reference(jx, axes, shape):
    m, mine = jx["mesh"](axes, shape), _sizes(axes, shape)
    for dims, kw in (((8, 128), {}), ((1, 128), dict(seq_dim=1)), ((6, 64), {}),
                     ((32, 2048), {}), ((1, 4096), dict(seq_dim=1, seq_axis="model")),
                     ((2, 12, 5), dict(seq_dim=1))):
        want = tuple(jx["sh"].batch_spec(m, dims, **kw))
        assert _norm(shlib.batch_spec(mine, dims, **kw)) == _norm(want), (dims, kw)


def _port_model(arch: str, reduced: bool):
    cfg = configs.get(arch)
    return Model(cfg.reduced() if reduced else cfg, device="meta")


def _jax_model(jx, arch: str, reduced: bool):
    cfg = jx["configs"].get(arch)
    return jx["Model"](cfg.reduced() if reduced else cfg)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch,reduced", ARCHS)
def test_tree_shardings_match_the_reference_per_layer(jx, arch, reduced, fsdp):
    """Model.specs() resolved by tree_shardings on the production meshes and a
    small one: every top leaf's spec equal to the reference's, every stage
    leaf's the reference's without its "layers" entry (which is None)."""
    jax = jx["jax"]
    model, jm = _port_model(arch, reduced), _jax_model(jx, arch, reduced)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    for axes, shape in MESHES[1:5]:
        mine = shlib.tree_shardings(_sizes(axes, shape), model.specs(), model.param_tree(),
                                    fsdp=fsdp)
        want = jx["sh"].tree_shardings(jx["mesh"](axes, shape), jm.specs(), shapes,
                                       fsdp=fsdp)
        for k in mine:
            if k != "stages":
                assert _norm(mine[k].spec) == _norm(want[k].spec), k
        for layers, stacked in zip(mine["stages"], want["stages"], strict=True):
            flat = jax.tree.leaves(stacked, is_leaf=lambda x: hasattr(x, "spec"))
            for layer in layers:
                for a, b in zip(shlib.sharding_leaves(layer), flat, strict=True):
                    assert tuple(b.spec)[0] is None
                    assert _norm(a.spec) == _norm(tuple(b.spec)[1:]), (arch, axes, a.spec,
                                                                       b.spec)


@pytest.mark.parametrize("axes,shape", MESHES)
def test_zero1_widen_matches_the_reference(jx, axes, shape):
    """_zero1_shardings on the full qwen1.5-0.5b's per-layer shardings and
    shapes, and the reference's on the same (its NamedShardings over an
    AbstractMesh, ShapeDtypeStructs of the per-layer shapes)."""
    jax = jx["jax"]
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as P
    model, sizes, m = _port_model("qwen1.5-0.5b", False), _sizes(axes, shape), \
        jx["mesh"](axes, shape)
    flat_p = _flat(model.param_tree())
    mine = shlib.tree_shardings(sizes, model.specs(), model.param_tree())
    flat_s = shlib.sharding_leaves(mine)
    got = shlib.sharding_leaves(_zero1_shardings(sizes, mine, model.param_tree()))
    want = jx["train"]._zero1_shardings(
        m, [JNS(m, P(*ns.spec)) for ns in flat_s],
        [jax.ShapeDtypeStruct(tuple(p.shape), np.float32) for p in flat_p])
    widened = 0
    for a, b, ns in zip(got, want, flat_s, strict=True):
        assert _norm(a.spec) == _norm(tuple(b.spec) + (None,) * (len(a.spec) - len(b.spec)))
        widened += a.spec != ns.spec
    dp = [a for a in ("pod", "data") if a in sizes]
    assert (widened > 0) == bool(dp), (axes, shape, widened)


def _flat(tree):
    from repro_torch.core.types import tree_flatten
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-9b"])
def test_cache_shardings_match_the_reference(jx, arch, batch):
    """The reduced models' cache trees (Model.make_caches, stacked over a
    stage's layers in both packages) on four mesh shapes."""
    jax = jx["jax"]
    model, jm = _port_model(arch, True), _jax_model(jx, arch, True)
    caches = model.make_caches(batch, 64)
    jcaches = jax.eval_shape(lambda: jm.make_caches(batch, 64))
    for axes, shape in MESHES[:4]:
        mine = shlib.sharding_leaves(shlib.cache_shardings(_sizes(axes, shape), caches,
                                                           model.cfg))
        want = jax.tree.leaves(jx["sh"].cache_shardings(jx["mesh"](axes, shape), jcaches,
                                                        jm.cfg))
        assert [_norm(a.spec) for a in mine] == [_norm(b.spec) for b in want], (arch, axes)


def test_placements_and_fleet_axis():
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"pod": 2, "data": 2, "model": 2}
    assert placements(sizes, (("pod", "data"), None, "model")) == [Shard(0), Shard(0),
                                                                    Shard(2)]
    assert placements(sizes, (None,)) == [Replicate()] * 3
    assert fleet_axis({"fleet": 2, "data": 4}) == "fleet"
    assert fleet_axis({"data": 4}) == "data"


def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="init_method"):
        tmesh.init_process_group(rank=0, world_size=2, device="cpu")
    x = torch.ones(3)
    assert constrain(x, ("batch",)) is x


# -- four ranks ----------------------------------------------------------------------------
def _psum_inputs(rank: int):
    """Rank r's gradient and residual: the magnitudes cluster on a few
    entries so the ranks' top-k indices collide, with values of very
    different scales (the order of the adds shows in the sums)."""
    rng = np.random.default_rng(100 + rank)
    g = rng.standard_normal(PSUM_SHAPE).astype(np.float32) * 1e-3
    g.reshape(-1)[:24] = (rng.standard_normal(24) * 10.0 ** rng.integers(-3, 4, 24)).astype(
        np.float32)
    res = (rng.standard_normal(PSUM_SHAPE) * 1e-4).astype(np.float32)
    return g, res


def mesh_rank(rank: int, tmp: str) -> None:
    """One rank: compressed_psum, the elastic restore, the meshes and the
    fleet placements; rank 0 writes what every rank read to tmp/mesh.pt."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    out: dict = {}
    g, res = (torch.from_numpy(x) for x in _psum_inputs(rank))
    first = compressed_psum(g, None, res, K_FRAC)
    second = compressed_psum(g, None, res, K_FRAC)
    out["psum"] = [x.numpy().copy() for x in first]
    out["psum_again"] = all(torch.equal(a, b) for a, b in zip(first, second))
    # meshes
    mesh2 = tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    out["mesh2"] = (tuple(mesh2.mesh.shape), mesh2.mesh_dim_names,
                    mesh2.get_local_rank("data"), mesh2.get_local_rank("model"))
    try:
        tmesh.make_mesh((2,), ("data",), device="cpu")
        out["wrong_world"] = None
    except ValueError as e:
        out["wrong_world"] = str(e)
    try:
        tmesh.make_production_mesh(device="cpu")
        out["production"] = None
    except ValueError as e:
        out["production"] = str(e)
    fm = fleet_mesh(device="cpu")
    out["fleet_mesh"] = (fm.mesh_dim_names, fm.size())
    try:
        fleet_mesh(2, device="cpu")
        out["fleet_n"] = None
    except ValueError as e:
        out["fleet_n"] = str(e)
    # shard_fleet / unshard / replicate (rank 0's values win)
    tree = {"a": torch.arange(16.0).reshape(8, 2) + 100 * rank,
            "b": [torch.arange(8, dtype=torch.int32) + rank]}
    sh = shard_fleet(tree, fm)
    out["fleet_local"] = (sh["a"].to_local().numpy().copy(), sh["b"][0].to_local().numpy().copy())
    out["fleet_whole"] = {k: x.numpy().copy() for k, x in
                          (("a", unshard(sh)["a"]), ("b", unshard(sh)["b"][0]))}
    out["replicated"] = replicate({"w": torch.full((3,), float(rank))}, fm)["w"].numpy().copy()
    # constrain: a DTensor is redistributed inside the mesh context, a plain
    # tensor passes through
    x = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh2, [Replicate(), Replicate()])
    plain = torch.ones(4, 8)
    with mesh2:
        y = constrain(x, ("batch", "mlp"))
        same = constrain(plain, ("batch", "mlp")) is plain
    out["constrain"] = (list(y.placements) == [Shard(0), Shard(1)], same,
                        torch.equal(y.full_tensor(), x.full_tensor()))
    # the elastic restore: a whole-tensor checkpoint placed over 4 ranks
    w = {"w": torch.arange(16.0).reshape(4, 4), "n": torch.arange(3, dtype=torch.int32)}
    if rank == 0:
        save_checkpoint(f"{tmp}/ckpt", 1, w)
    dist.barrier()
    dmesh = tmesh.make_mesh((WORLD,), ("data",), device="cpu")
    shard = {"w": NamedSharding(dmesh, ("data", None)), "n": NamedSharding(dmesh, (None,))}
    got, step = load_checkpoint(f"{tmp}/ckpt", w, device="cpu", shardings=shard)
    again, _ = CheckpointManager(f"{tmp}/ckpt").restore(w, device="cpu", shardings=shard)
    out["restore"] = (step, isinstance(got["w"], DTensor), got["w"].to_local().numpy().copy(),
                      got["w"].full_tensor().numpy().copy(), got["n"].full_tensor().numpy(),
                      list(got["w"].placements) == [Shard(0)],
                      torch.equal(again["w"].to_local(), got["w"].to_local()))
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, out)
    if rank == 0:
        torch.save(gathered, f"{tmp}/mesh.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank run (a thread waits for it) and, meanwhile, the training
    entry point at --mesh 2 with no process group (it starts its 2 ranks
    itself) beside a one-device run."""
    tmp = tmp_path_factory.mktemp("pshard")
    failed = []

    def run():
        try:
            tmesh.spawn(mesh_rank, WORLD, (str(tmp),),
                        init_method=f"file://{tmp / 'rendezvous'}", device="cpu")
        except Exception as e:  # surfaced below
            failed.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    spawned = launch_train.main(LAUNCH + ["--mesh", "2", "--ckpt-dir", str(tmp / "two")])
    one = launch_train.main(LAUNCH + ["--ckpt-dir", str(tmp / "one")])
    thread.join(timeout=240)
    assert not thread.is_alive(), "the ranks did not finish in 240 s"
    if failed:
        raise failed[0]
    return dict(out=torch.load(tmp / "mesh.pt", weights_only=False), spawned=spawned, one=one)


def test_compressed_psum_matches_the_reference_to_the_bit(jx, ranks):
    """Every rank's (sum, new residual) against the reference's
    compressed_psum under jax.vmap over the 4 ranks' inputs; two calls give
    the same bits; the ranks' top-k indices do collide."""
    jax = jx["jax"]
    gs, rs = zip(*(_psum_inputs(r) for r in range(WORLD)))
    fn = jax.vmap(lambda g, r: jx["comp"].compressed_psum(g, "i", r, K_FRAC), axis_name="i")
    want_sum, want_res = (np.asarray(x) for x in fn(np.stack(gs), np.stack(rs)))
    for r, out in enumerate(ranks["out"]):
        got_sum, got_res = out["psum"]
        assert np.array_equal(got_sum, want_sum[r]), r
        assert np.array_equal(got_res, want_res[r]), r
        assert out["psum_again"]
    idx = [set(np.argsort(-np.abs(g + res).reshape(-1))[:int(g.size * K_FRAC)])
           for g, res in zip(gs, rs)]
    assert len(set.union(*idx)) < sum(len(i) for i in idx)


def test_compressed_psum_adds_ranks_in_rank_order(ranks):
    """The sum equals a float32 left fold of the ranks' g_hat in rank order
    (error_feedback_update's), element by element, and differs from the
    reverse order somewhere (so the order is seen)."""
    hats = []
    for r in range(WORLD):
        g, res = (torch.from_numpy(x) for x in _psum_inputs(r))
        hats.append(error_feedback_update(g, res, K_FRAC)[0].numpy())
    fold = np.zeros(PSUM_SHAPE, np.float32)
    for h in hats:
        fold = fold + h
    back = np.zeros(PSUM_SHAPE, np.float32)
    for h in hats[::-1]:
        back = back + h
    got = ranks["out"][0]["psum"][0]
    assert np.array_equal(got, fold)
    assert not np.array_equal(fold, back)


def test_meshes_on_four_ranks(ranks):
    for r, out in enumerate(ranks["out"]):
        assert out["mesh2"] == ((2, 2), ("data", "model"), r // 2, r % 2)
        assert "needs 2 ranks" in out["wrong_world"] and "has 4" in out["wrong_world"]
        assert "needs 256 ranks" in out["production"]
        assert out["fleet_mesh"] == (("fleet",), WORLD)
        assert "every rank" in out["fleet_n"]


def test_shard_fleet_unshard_and_replicate(ranks):
    whole = np.arange(16.0).reshape(8, 2)        # rank 0's values, scattered
    for r, out in enumerate(ranks["out"]):
        a, b = out["fleet_local"]
        np.testing.assert_array_equal(a, whole[2 * r:2 * r + 2])
        np.testing.assert_array_equal(b, np.arange(8)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["fleet_whole"]["a"], whole)
        np.testing.assert_array_equal(out["replicated"], np.zeros(3))
        assert out["constrain"] == (True, True, True)


def test_elastic_restore_places_each_leaf_by_its_sharding(ranks):
    """The counterpart of tests/test_runtime.py's elastic restore: a
    checkpoint of whole tensors restored onto a 4-rank mesh, each rank its
    row of w, n replicated; the manager's restore the same."""
    w = np.arange(16.0).reshape(4, 4)
    for r, out in enumerate(ranks["out"]):
        step, is_dt, local, whole, n, placed, same = out["restore"]
        assert step == 1 and is_dt and placed and same
        np.testing.assert_array_equal(local, w[r:r + 1])
        np.testing.assert_array_equal(whole, w)
        np.testing.assert_array_equal(n, np.arange(3))


def test_entry_point_starts_its_own_ranks(ranks):
    """launch.train.main --mesh 2 without a process group starts its 2 ranks
    and returns rank 0's result: the loss within 1e-5 of the one-device
    run's (one bf16 step; the ranks' halves summed in another order)."""
    two, one = ranks["spawned"], ranks["one"]
    assert two["done"] == 1 and two["state"] is None
    assert two["losses"][0] == pytest.approx(one["losses"][0], rel=1e-5)
