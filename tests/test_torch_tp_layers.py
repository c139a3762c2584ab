"""The tensor-parallel pieces that need no ranks (models/tp.py, the flat
layout's choice, the refusals), on the CPU.

- local_slice: every leaf of a model's parameters, cut to each rank's shard
  by Params.load_ (the path convert.model_params_from_numpy takes) on
  meshes (1, 3), (2, 2) and (1, 4), and put back at the slices of its
  tree_shardings spec, is the whole leaf again;
- TP.lse_combine over the partial softmaxes of key chunks (a simulated
  group: the ranks stacked on a leading dim, the all-reduce a sum or max
  over it) equals one softmax over all the keys;
- Model(cfg, tp_size=M) picks the attention layout and heads_padded as
  the JAX package's Model does (src/repro/models/model.py:42-46) for every
  arch and M in 1..8, and its parameter shapes (the padded wq / wo / bq)
  are the reference's;
- the xLSTM state layouts: a state split over "model" on hd, assembled
  as the heads a rank runs and cut back (xlstm._heads_in / _heads_out,
  with a simulated group), is the state again;
- TP.splits reads each leaf's own width: MoE's "mlp" at d_ff, moe_d_ff
  and the shared experts', xLSTM's "qkv" at h * hd and 4 * h * hd;
- training on a model axis above 1: the dense and hybrid families build
  (each rank's float32 shard, on a stand-in mesh), their per-rank partial
  gradients named by placement (Model.grad_kinds), and the other families
  still raise (Model(mesh=, trainable=True), launch/train.py --mesh 1x2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.types import tree_flatten  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import Model, tp  # noqa: E402
from repro_torch.models.layers import Params  # noqa: E402
from repro_torch.runtime import serve, sharding  # noqa: E402

TP_ARCHS = ("qwen1.5-0.5b", "recurrentgemma-9b")
REFUSED = ("deepseek-moe-16b", "xlstm-125m", "llama-3.2-vision-11b", "whisper-small")
# Every family: the dense and hybrid archs, then the rest
ALL_ARCHS = TP_ARCHS + REFUSED


def _coords(sizes: dict):
    axes = list(sizes)
    for flat in range(int(np.prod(list(sizes.values())))):
        coord, rest = {}, flat
        for ax in reversed(axes):
            coord[ax] = rest % sizes[ax]
            rest //= sizes[ax]
        yield coord


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape", [(1, 3), (2, 2), (1, 4)])
def test_shards_put_back_are_the_whole_leaves(arch, shape):
    """The top leaves and the first layer of each stage (the experts, the
    xLSTM heads and gates, the cross attention and the encoder among
    them). Reduced xlstm-125m holds no leaf that splits over 3."""
    sizes = {"data": shape[0], "model": shape[1]}
    model = Model(configs.get(arch).reduced(), device="meta", tp_size=shape[1])
    gen = torch.Generator().manual_seed(0)
    specs, shapes = model.specs(), model.param_shapes()
    parts = [(model._top_defs(), {k: v for k, v in specs.items() if k != "stages"},
              {k: v for k, v in shapes.items() if k != "stages"})]
    parts += [(layers[0].p.defs, specs["stages"][i][0], shapes["stages"][i][0])
              for i, layers in enumerate(model.stage_layers)]
    split = 0
    for defs, axes, meta in parts:
        placed = sharding.tree_shardings(sizes, axes, meta)
        whole = sharding.map_shardings(lambda sh, x: torch.randn(x.shape, generator=gen),
                                       placed, meta)
        back = sharding.map_shardings(lambda sh, x: torch.full_like(x, float("nan")),
                                      placed, whole)
        for coord in _coords(sizes):
            shard = Params(defs, "cpu", trainable=True,
                           place=tp.Placement(sizes, coord)).load_(whole).tree()
            sharding.map_shardings(
                lambda sh, dst, src: dst.__setitem__(
                    sharding.local_slice(tuple(dst.shape), sh.spec, sizes, coord), src.detach()),
                placed, back, shard)
            split += sum(tuple(a.shape) != tuple(b.shape) for a, b in zip(
                tree_flatten(shard)[0], tree_flatten(whole)[0], strict=True))
        for a, b in zip(tree_flatten(back)[0], tree_flatten(whole)[0], strict=True):
            assert torch.equal(a, b)
    assert (split > 0) == (arch != "xlstm-125m" or shape[1] != 3), (arch, shape, split)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape", [(1, 3), (2, 2)])
def test_cache_shards_put_back_are_the_whole_caches(arch, shape):
    """convert.caches_from_numpy(whole, like, model) on each rank's model
    (its placement set as a mesh would give it) holds the slices of
    cache_shardings; put back, they are the whole caches: KV and RG-LRU
    caches, the xLSTM states (split on hd), "frontend" and "enc_out"
    (split over the batch, whole over "model")."""
    from repro_torch import convert
    from repro_torch.core.types import tree_map
    sizes = {"data": shape[0], "model": shape[1]}
    b, max_len = 4, 108
    model = Model(configs.get(arch).reduced(), device="meta", tp_size=shape[1])
    gen = torch.Generator().manual_seed(1)
    whole = tree_map(lambda x: torch.randn(x.shape, generator=gen),
                     model._make_caches(b, max_len, "meta"))
    placed = sharding.cache_shardings(sizes, whole, model.cfg)
    back = tree_map(lambda x: torch.full_like(x, float("nan")), whole)
    split = 0
    for coord in _coords(sizes):
        model.place = tp.Placement(sizes, coord)
        like = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32),
                        model.make_caches(b // shape[0], max_len))
        got = convert.caches_from_numpy(convert.to_numpy(whole), like, model)
        sharding.map_shardings(
            lambda sh, dst, src: dst.__setitem__(
                sharding.local_slice(tuple(dst.shape), sh.spec, sizes, coord), src),
            placed, back, got)
        split += sum(tuple(x.shape) != tuple(y.shape) for x, y in zip(
            tree_flatten(got)[0], tree_flatten(whole)[0], strict=True))
    for a, b_ in zip(tree_flatten(back)[0], tree_flatten(whole)[0], strict=True):
        assert torch.equal(a, b_)
    # over 3: recurrentgemma's 64-slot window and 128 channels and xlstm's
    # hd of 32 stay whole; the flat layouts' 108-slot caches split
    splits = any(sizes.get(ax, 1) > 1 for sh in sharding.sharding_leaves(placed)
                 for e in sh.spec if e is not None
                 for ax in (e if isinstance(e, tuple) else (e,)))
    assert (split > 0) == splits and splits == (
        shape != (1, 3) or arch not in ("recurrentgemma-9b", "xlstm-125m"))
    if shape == (2, 2) and arch in ("llama-3.2-vision-11b", "whisper-small"):
        key = "frontend" if arch.startswith("llama") else "enc_out"
        assert placed[key].spec == (("data",), None, None)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 3), (2, 2)])
def test_fresh_caches_are_the_whole_caches_shards(arch, shape):
    """Model.make_caches on each rank (its placement set as a mesh would
    give it) holds the values of its slice of the unsharded model's fresh
    caches: empty KV slots at -1, an sLSTM's stabiliser m at -1e30, zeros
    elsewhere."""
    sizes = {"data": shape[0], "model": shape[1]}
    b, max_len = 4, 108
    model = Model(configs.get(arch).reduced(), device="cpu", tp_size=shape[1])
    whole = model._make_caches(b, max_len, "cpu")
    for coord in _coords(sizes):
        model.place = tp.Placement(sizes, coord)
        got, want = model.make_caches(b // shape[0], max_len), model.local_caches(whole)
        for x, y in zip(tree_flatten(got)[0], tree_flatten(want)[0], strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), (arch, shape, coord)


def test_local_slice_places_joint_axes_major_first():
    sizes, spec = {"pod": 2, "data": 3, "model": 2}, (("pod", "data"), "model")
    got = [sharding.local_slice((12, 4), spec, sizes, c) for c in _coords(sizes)]
    assert [(r.start, c.start) for r, c in got] == [
        (2 * (p * 3 + d), 2 * m) for p in range(2) for d in range(3) for m in range(2)]
    assert sharding.local_shape((12, 4), spec, sizes) == (2, 2)


def _stacked_reduce(x, op, group=None):
    """The all-reduce of a simulated group: the ranks stacked on dim 0."""
    import torch.distributed as dist
    red = x.amax(0, keepdim=True) if op == dist.ReduceOp.MAX else x.sum(0, keepdim=True)
    x.copy_(red.expand_as(x))


@pytest.mark.parametrize("ranks", [2, 3, 4])
def test_lse_combine_equals_one_softmax(ranks):
    gen = torch.Generator().manual_seed(ranks)
    s = 4.0 * torch.randn(5, 7, 12 * ranks, generator=gen, dtype=torch.float64)
    v = torch.randn(5, 12 * ranks, 16, generator=gen, dtype=torch.float64)
    s[0, :, : 12 * ranks - 3] = -1e30          # one row sees only the last rank's keys
    want = torch.einsum("bqc,bcd->bqd", torch.softmax(s, -1), v)
    sc = s.view(5, 7, ranks, 12).permute(2, 0, 1, 3)
    vc = v.view(5, ranks, 12, 16).permute(1, 0, 2, 3)
    m = sc.amax(-1)
    p = torch.exp(sc - m[..., None])
    p = torch.where(sc > -1e29, p, 0.0)
    acc = torch.einsum("rbqc,rbcd->rbqd", p, vc)
    group = tp.TP(size=ranks, all_reduce=_stacked_reduce)
    got = group.lse_combine(m, p.sum(-1), acc)
    for r in range(ranks):
        torch.testing.assert_close(got[r], want, rtol=1e-12, atol=1e-12)


def test_gather_cols_is_an_all_reduce_of_slices():
    seen = []

    def reduce(x, op, group=None):
        seen.append((tuple(x.shape), op))
        x.mul_(1)
    part = torch.arange(6.0).view(2, 3)
    got = tp.TP(size=4, rank=2, all_reduce=reduce).gather_cols(part)
    assert got.shape == (2, 12) and torch.equal(got[:, 6:9], part)
    assert float(got.abs().sum()) == float(part.sum())
    import torch.distributed as dist
    assert seen == [((2, 12), dist.ReduceOp.SUM)]


def test_layout_and_padded_heads_match_the_reference():
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.models import Model as JModel
    for name in configs.all_names():
        for m in range(1, 9):
            want = JModel(jconfigs.get(name), tp_size=m).cfg
            got = Model(configs.get(name), device="meta", tp_size=m).cfg
            assert (got.attn_layout, got.heads_padded) == (want.attn_layout,
                                                           want.heads_padded), (name, m)
    for name in TP_ARCHS:
        jm = JModel(jconfigs.get(name).reduced(), tp_size=3)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        mine = Model(configs.get(name).reduced(), device="meta", tp_size=3).param_shapes()
        st = mine["stages"]
        for i, layers in enumerate(st):
            for leaf, path in ((lay[k], k) for lay in layers for k in ("attn", "rglru")
                               if k in lay):
                ref = shapes["stages"][i][path]
                for key, x in leaf.items():
                    assert tuple(x.shape) == tuple(ref[key].shape[1:]), (name, path, key)


@pytest.mark.parametrize("name", REFUSED)
def test_other_families_on_a_model_axis_raise(name):
    """The four families that served on a model axis before they trained on
    one now build trainable on a stand-in mesh of (1, 2), every leaf a
    float32 shard that requires grad, and jit_train_step(fsdp=True) builds
    on it: every leaf with an "embed" dim FSDP splits (over a data axis of
    1 here) keeps its shape and requires grad (the test's name is from the
    slice that refused them; tests/test_torch_fsdp_pod.py steps them)."""
    from repro_torch.runtime import train as t_train
    cfg = configs.get(name).reduced()
    model = Model(cfg, device="meta", trainable=True,
                  mesh=_StandInMesh({"data": 1, "model": 2}, {"data": 0, "model": 1}))
    assert all(p.dtype == torch.float32 and p.requires_grad for p in model.parameters())
    shapes = [tuple(p.shape) for p in tree_flatten(model.param_tree())[0]]
    make, shard = t_train.jit_train_step(model, model.mesh, fsdp=True)
    assert callable(make({"tokens": (2, 8), "targets": (2, 8)}))
    assert [tuple(p.shape) for p in tree_flatten(model.param_tree())[0]] == shapes
    assert all(p.requires_grad for p in model.parameters())
    axes = model._per_leaf(lambda d, spec, local: d.axes)
    assert [axes[i][d] if d >= 0 else None for i, d in enumerate(model.data_dims())] == \
        ["embed" if "embed" in a else None for a in axes], name
    assert [sharding.placements(model.mesh, ns.spec) for ns in
            sharding.sharding_leaves(shard.params)] == [
        sharding.placements(model.mesh, model.place.spec(*dims)) for dims in
        model._per_leaf(lambda d, spec, local: (d.axes, d.shape))]
    model = Model(cfg, device="meta", tp_size=2)
    assert all(d.shape for d in model.stage_layers[0][0].p.defs.values()
               if not isinstance(d, dict))


def _stacked_group(ranks: int):
    """tp.TP handles of a simulated group, one a rank, called in turn: the
    last rank's all-reduce writes the sum into every rank's buffer (so what
    an earlier rank holds, its buffer or a view of it, is filled then)."""
    pending: list = []

    def reduce(x, op, group=None):
        pending.append(x)
        if len(pending) == ranks:
            total = sum(t.clone() for t in pending)
            for t in pending:
                t.copy_(total)
            pending.clear()
    return [tp.TP(size=ranks, rank=r, all_reduce=reduce) for r in range(ranks)]


@pytest.mark.parametrize("heads_split,state_split", [(True, True), (False, True),
                                                     (True, False)])
def test_xlstm_state_layouts_round_trip(heads_split, state_split):
    """A state (B, H, hd, hd) held as the cache holds it over 2 ranks (split
    on its last dim, or whole), assembled as the heads each rank runs
    (_heads_in) is those heads of the whole state; cut back (_heads_out),
    it is each rank's shard again."""
    from repro_torch.models import xlstm
    b, h, hd = 3, 4, 6
    whole = torch.randn(b, h, hd, hd, generator=torch.Generator().manual_seed(2))
    group = _stacked_group(2)
    for g in group:
        g.state_split = {"C": state_split}
    shards = [g.take(whole, -1) if state_split else whole for g in group]
    ins = [xlstm._heads_in({"C": sh}, g, heads_split)["C"] for g, sh in zip(group, shards)]
    for g, got in zip(group, ins):
        assert torch.equal(got, g.take(whole, 1) if heads_split else whole)
    outs = [xlstm._heads_out({"C": x}, g, heads_split)["C"] for g, x in zip(group, ins)]
    for got, want in zip(outs, shards):
        assert torch.equal(got, want)


def test_splits_read_each_leafs_own_width():
    """The widths catalogue and the per-leaf flags on a model axis of 3 (a
    simulated mesh) and of 2."""
    ds = configs.get("deepseek-moe-16b").reduced()
    got = tp.widths(ds, 512)
    assert got["mlp"] == (64, 256) and got["experts"] == (8,) and got["heads"] == ()
    xl = configs.get("xlstm-125m").reduced()
    assert tp.widths(xl, 512)["qkv"] == (128, 512) and tp.widths(xl, 512)["heads"] == (4,)

    def handle(cfg, m):
        split = {(ax, w): sharding.spec_for({"model": m}, (ax,), (w,))[0] == "model"
                 for ax, ws in tp.widths(cfg, 512).items() for w in ws}
        return tp.TP(size=m, split=split)
    h3, h2 = handle(ds, 3), handle(ds, 2)
    assert not tp.split(h3, "experts", 8) and not tp.split(h3, "mlp", 64)
    assert tp.split(h2, "experts", 8) and tp.split(h2, "mlp", 64) and tp.split(h2, "mlp", 256)
    assert not tp.split(None, "mlp", 64) and not tp.split(h2, "mlp", 65)
    x48 = handle(dataclasses.replace(xl, head_dim=48), 3)
    assert (tp.split(x48, "qkv", 192) and tp.split(x48, "qkv", 768)
            and not tp.split(x48, "heads", 4))


class _StandInMesh:
    """What Model(mesh=) reads of a DeviceMesh, for one rank of a mesh of
    ``sizes`` at ``coord``, with no process group (a model on the meta
    device issues no collective)."""

    def __init__(self, sizes: dict, coord: dict):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.arange(int(np.prod(list(sizes.values())))).reshape(
            tuple(sizes.values()))
        self._coord = coord

    def get_coordinate(self):
        return [self._coord[a] for a in self.mesh_dim_names]

    def get_local_rank(self, axis):
        return self._coord[axis]

    def get_group(self, axis):
        return None


# the leaves whose gradient is a per-rank partial (Model.grad_kinds): a
# replicated wk / wv (and their biases) beside split query heads, in the
# self and the cross attention; the whole wi / wf / r_zifo of an xLSTM
# whose heads are cut (head_dim 48 on 3 ranks: every head run, the rank's
# columns kept); never the MoE's router (its gates enter, moe.moe_apply)
PARTIALS = {("qwen1.5-0.5b", 2): set(), ("qwen1.5-0.5b", 3): {"wk", "wv", "bk", "bv"},
            ("recurrentgemma-9b", 2): set(), ("recurrentgemma-9b", 3): {"wk", "wv"},
            ("deepseek-moe-16b", 2): set(), ("deepseek-moe-16b", 3): {"wk", "wv"},
            ("xlstm-125m", 2): set(), ("xlstm-125m", 3): set(),
            ("xlstm-125m hd48", 3): {"wi", "wf", "r_zifo"},
            ("llama-3.2-vision-11b", 2): set(), ("llama-3.2-vision-11b", 3): {"wk", "wv"},
            ("whisper-small", 2): set(), ("whisper-small", 3): {"wk", "wv"}}


def _case_cfg(name: str):
    """A PARTIALS case's reduced config ("<arch> hd48": head_dim 48)."""
    arch, _, variant = name.partition(" ")
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, head_dim=48) if variant == "hd48" else cfg


def test_training_on_a_model_axis_raises():
    """Every family builds trainable on a model axis of 2 and 3 (each leaf
    the float32 shard its placement assigns, every leaf SPLIT, PARTIAL or
    WHOLE as its placement and its mixer say; the MoE router WHOLE); only
    FSDP still raises, naming the TP item (tests/test_torch_train_dp.py;
    the test's name is from the slices that refused a model axis); --mesh
    1x2 parses."""
    from repro_torch.models.model import PARTIAL, SPLIT, WHOLE
    assert launch_train.check_mesh("1x2") == ((1, 2), ("data", "model"))
    for (name, m), partial in PARTIALS.items():
        sizes = {"data": 1, "model": m}
        model = Model(_case_cfg(name), device="meta", trainable=True,
                      mesh=_StandInMesh(sizes, {"data": 0, "model": m - 1}))
        whole = model.param_shapes()
        for p, x, sh in zip(tree_flatten(model.param_tree())[0], tree_flatten(whole)[0],
                            sharding.sharding_leaves(sharding.tree_shardings(
                                sizes, model.specs(), whole))):
            assert p.dtype == torch.float32 and p.requires_grad
            assert tuple(p.shape) == sharding.local_shape(tuple(x.shape), sh.spec, sizes)
        names, kinds = _leaf_names(model), model.grad_kinds()
        assert len(kinds) == len(names)
        got = {n.rsplit(".", 1)[-1] for n, k in zip(names, kinds) if k == PARTIAL}
        assert got == partial, (name, m, got)
        for n, k, sh in zip(names, kinds, sharding.sharding_leaves(sharding.tree_shardings(
                sizes, model.specs(), whole))):
            assert (k == SPLIT) == ("model" in sh.spec), (name, m, n)
            assert k in (SPLIT, PARTIAL, WHOLE)
            if n.endswith(".moe.router"):
                assert k == WHOLE, (name, m, n)


def _leaf_names(model) -> list:
    """Each parameter's dotted path, in tree_flatten order of param_tree()."""
    out = []

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{prefix}.{k}" if prefix else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}.{i}")
        else:
            out.append(prefix)
    walk(model.param_tree(), "")
    return out


def test_a_model_not_built_on_the_mesh_is_refused():
    model = Model(configs.get("qwen1.5-0.5b").reduced(), device="meta")
    with pytest.raises(ValueError, match="built on this mesh"):
        serve.jit_prefill(model, {"data": 1, "model": 2}, 16)
