"""Tensor parallelism over a mesh's "model" axis: the collectives that GSPMD
inserts for the JAX package's model-axis specs, written out.

The JAX package declares each parameter's logical axes and lets GSPMD
partition the program. The port places each leaf as the same specs say
(pshard.spec_for: a rank holds the slice pshard.local_slice gives it; a dim that
does not divide stays whole) and computes on plain local tensors, with the
reductions and gathers named here, on the mesh's "model" sub-group:

  reduce (Megatron's "g")            row-parallel matmuls and the
                                     vocab-parallel embedding: the sum over
                                     the group forward, the identity
                                     backward (the summed output feeds
                                     computation every rank repeats);
  enter (Megatron's "f")             a replicated activation entering
                                     rank-local computation: the identity
                                     forward, the sum of the ranks'
                                     cotangents backward;
  gather                             a dim split over the ranks made whole
                                     (logits, K / V split inside a head); its
                                     backward takes the rank's slice (K / V,
                                     used for the rank's own heads only, go
                                     through enter after it);
  reduce_take                        the RG-LRU gates: partial products
                                     summed, each rank keeping its channels;
                                     backward, the slices' cotangents
                                     gathered;
  rows_sum                           a batch split into row blocks over
                                     ("pod", "data"): each block's partial
                                     sums (the MoE router's statistics)
                                     summed over the blocks, the identity
                                     backward;
  all_reduce_sum / all_reduce_max    the raw collectives: the
                                     flash-decoding combine, the xLSTM
                                     states' layouts;
  lse_combine                        the ranks' partial softmax attention over
                                     their cache slots merged into one.

The first five are autograd Functions where a graph is built (grad on and
an input that requires grad); otherwise the first four issue exactly the
serving path's collectives on the same buffers (serving never calls
rows_sum). A replicated leaf that a
rank-local computation uses gets a per-rank partial gradient, which the
train step sums over the group (Model.grad_kinds).

FSDP (runtime.train.jit_train_step(fsdp=True)) holds a leaf whose
"embed" dim splits over the mesh's data axes ("pod", "data") as this
rank's slice of it too (Placement.fsdp), and DataShards, the handle of
those axes' group, adds the pair:

  gather_leaf                        a leaf gathered whole over the data
                                     axes before use; backward, the reduce
                                     over them of its cotangent, each rank
                                     weighted by its token share (scale)
                                     and keeping its slice.

Every collective is an all-reduce: a gather is the all-reduce of a
zero-filled whole buffer in which each rank writes its slice, a reduce
kept as a slice the all-reduce of the whole cotangent, sliced. So one
code path runs on NCCL, on gloo over CPU tensors and on gloo over CUDA
tensors (which takes all_reduce but not all_gather or reduce_scatter).
The handle takes its all-reduce as an argument
(``torch.distributed.all_reduce`` by default), so a caller may stage it
through the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.pshard import local_shape, local_slice, mesh_shape, spec_for

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")
# The logical axes of the parameters that the rules put on "model"
# (pshard.RULES). One axis may take several widths in one model (MoE:
# "mlp" at d_ff, moe_d_ff and the shared experts'; xLSTM: "qkv" at h * hd
# and 4 * h * hd), which need not all divide the axis: TP.split holds a flag
# for each (axis, width) that widths() lists.
SPLIT_AXES = ("vocab", "qkv", "kv", "mlp", "lru", "experts", "heads")


def mesh_coord(mesh) -> dict[str, int]:
    """This rank's coordinate on each named dim of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def dim_on(spec: tuple, axes: tuple) -> int:
    """The first dim of ``spec`` whose entry names one of ``axes``, or -1."""
    for d, entry in enumerate(spec):
        if entry is not None and set(entry if isinstance(entry, tuple) else (entry,)) & set(axes):
            return d
    return -1


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank sits on a mesh: the axis sizes and its coordinate. A
    parameter def's spec is pshard.spec_for of its logical axes and full
    shape (with ``fsdp``, its "embed" dim split over the data axes as
    well); its local shape and slice follow."""

    sizes: dict
    coord: dict
    fsdp: bool = False

    @classmethod
    def on(cls, mesh) -> "Placement":
        return cls(mesh_shape(mesh), mesh_coord(mesh))

    def spec(self, axes: tuple, shape: tuple) -> tuple:
        return spec_for(self.sizes, axes, tuple(shape), fsdp=self.fsdp)

    def local_shape(self, axes: tuple, shape: tuple) -> tuple:
        return local_shape(tuple(shape), self.spec(axes, shape), self.sizes)

    def slice(self, axes: tuple, shape: tuple) -> tuple:
        return local_slice(tuple(shape), self.spec(axes, shape), self.sizes, self.coord)


class Group:
    """A sub-group of a mesh's ranks as the layers see it: its size, this
    rank's index in it, the process group and the all-reduce to use
    (``all_reduce(tensor, op=..., group=...)``, in place;
    torch.distributed.all_reduce unless given). A group of size 1 issues
    its collectives too, so they are captured where a mesh is given."""

    def __init__(self, size: int = 1, rank: int = 0, group=None,
                 all_reduce: Callable | None = None):
        self.size, self.rank, self.group = int(size), int(rank), group
        self._all_reduce = all_reduce

    def _reduce(self, x, op: str, group):
        import torch.distributed as dist
        x = x.contiguous()
        fn = self._all_reduce or dist.all_reduce
        fn(x, op=getattr(dist.ReduceOp, op), group=group)
        return x

    def all_reduce_sum(self, x):
        """x summed over the group (in place on x when contiguous)."""
        return self._reduce(x, "SUM", self.group)

    def all_reduce_max(self, x):
        return self._reduce(x, "MAX", self.group)

    def offset(self, n_local: int) -> int:
        """The first global index of this rank's slice of a split dim."""
        return self.rank * n_local

    def _gather(self, x, dim: int):
        dim %= x.ndim
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
        buf.narrow(dim, self.offset(n), n).copy_(x)
        return self.all_reduce_sum(buf)

    def take(self, x, dim: int = -1):
        """This rank's slice of a whole dim that splits over the group."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.offset(n), n)


class TP(Group):
    """The model axis as the layers see it (a Group): which leaves are split
    over it (``split``: (axis, width) -> bool, True where pshard.spec_for
    puts a leaf's dim of that logical axis and width on "model"; the
    function split() reads it), which xLSTM state leaves the caches hold
    split on their last dim (``state_split``: key -> bool, from
    runtime.sharding.cache_shardings; the model fills it), and the batch's
    row blocks over ("pod", "data") (``rows``: their count and this rank's
    index). On a mesh without a "model" axis the handle has size 1 and no
    group: no leaf splits, so its layers issue no model collective, and it
    carries the row blocks."""

    def __init__(self, size: int = 1, rank: int = 0, group=None, split: dict | None = None,
                 all_reduce: Callable | None = None, rows: tuple = (1, 0),
                 state_split: dict | None = None):
        super().__init__(size, rank, group, all_reduce)
        self.split = dict(split or {})
        self.state_split = dict(state_split or {})
        # (count, index) of the batch's row blocks over ("pod", "data")
        self.rows = tuple(rows)

    @classmethod
    def on_mesh(cls, mesh, widths: dict, all_reduce: Callable | None = None) -> "TP":
        """The handle of this rank's "model" sub-group of ``mesh`` (of size 1
        and no group where the mesh has no "model" axis); ``widths`` maps
        each logical axis of SPLIT_AXES to the model's widths on it
        (widths())."""
        sizes = mesh_shape(mesh)
        split = {(ax, w): spec_for(sizes, (ax,), (w,))[0] == MODEL_AXIS
                 for ax, ws in widths.items() for w in ws}
        coord = mesh_coord(mesh)
        count, index = 1, 0
        for ax in DATA_AXES:
            if ax in sizes:
                count, index = count * sizes[ax], index * sizes[ax] + coord[ax]
        if MODEL_AXIS not in sizes:
            return cls(1, 0, None, split, all_reduce, (count, index))
        return cls(sizes[MODEL_AXIS], mesh.get_local_rank(MODEL_AXIS),
                   mesh.get_group(MODEL_AXIS), split, all_reduce, (count, index))

    def gather(self, x, dim: int = -1):
        """A dim split over the group made whole: each rank writes its slice
        into a zero-filled buffer n * size long on ``dim``, then all-reduce
        (adding zeros changes no value). Backward: the rank's slice of the
        cotangent (the whole result is used alike on every rank)."""
        if _graph(x):
            return _Gather.apply(x, self, dim % x.ndim)
        return self._gather(x, dim)

    def gather_cols(self, x):
        """The last dim split over the group made whole (gather)."""
        return self.gather(x, -1)

    def reduce(self, x):
        """A partial result summed over the group (a row-parallel matmul's
        output, the vocab-parallel embedding); the identity backward."""
        if _graph(x):
            return _Reduce.apply(x, self)
        return self.all_reduce_sum(x)

    def enter(self, x):
        """A replicated activation entering rank-local computation: itself
        forward; backward, the ranks' partial cotangents summed."""
        if _graph(x):
            return _Enter.apply(x, self)
        return x

    def _reduce_take(self, parts, dim: int):
        both = self.all_reduce_sum(torch.stack(parts))
        n = both.shape[dim] // self.size
        mine = both.narrow(dim, self.offset(n), n)
        return tuple(mine[i] for i in range(len(parts)))

    def reduce_take(self, parts: list, dim: int = -1) -> tuple:
        """Partial products (each rank's sum over its channels) summed over
        the group in one buffer, each rank keeping its slice of ``dim``
        (the RG-LRU gates). Backward: the slices' cotangents gathered whole
        (each rank uses its slice differently, so a slice's gradient reaches
        every rank's partial product)."""
        dim %= parts[0].ndim
        if _graph(*parts):
            return _ReduceTake.apply(self, dim + 1, *parts)
        return self._reduce_take(parts, dim + 1)

    def row_table(self, counts):
        """(count of row blocks, n) table of every row block's ``counts`` (n,)
        int64, this rank's written at its index: one all-reduce over the
        whole mesh (each block's row is written by the group's ``size``
        ranks, and divided back). A batch held whole gives (1, n) without a
        collective."""
        n_blocks, index = self.rows
        if n_blocks == 1:
            return counts[None]
        table = torch.zeros((n_blocks, counts.shape[0]), dtype=torch.int64,
                            device=counts.device)
        table[index] = counts
        import torch.distributed as dist
        return self._reduce(table, "SUM", dist.group.WORLD) // self.size

    def _rows_sum(self, x):
        n_blocks, index = self.rows
        table = torch.zeros((n_blocks, *x.shape), dtype=x.dtype, device=x.device)
        if self.rank == 0:
            table[index] = x
        import torch.distributed as dist
        return self._reduce(table, "SUM", dist.group.WORLD).sum(0)

    def rows_sum(self, x):
        """``x`` (each row block's partial sums, alike on the ranks of a
        block's group) summed over the batch's row blocks: one all-reduce
        over the whole mesh of a (count of row blocks, ...) table, each
        block's row written by its group's first rank, then summed over the
        blocks in order (the same bits on every rank). Backward: the
        identity (the sum is used alike on every rank, each block's share of
        it by the block's own rows). A batch held whole gives x."""
        if self.rows[0] == 1:
            return x
        if _graph(x):
            return _RowsSum.apply(x, self)
        return self._rows_sum(x)

    def lse_combine(self, m, l, acc):
        """Softmax attention whose keys are split over the group, merged:
        each rank's partial row max ``m`` (...), sum ``l`` (...) of exp(s -
        m) and ``acc`` (..., d) of exp(s - m) v, all float32. The max is
        all-reduced, then the rescaled sums and outputs in one buffer.
        Returns the normalised output (..., d) float32."""
        m_all = self.all_reduce_max(m.clone())
        scale = torch.exp(m - m_all)
        both = torch.cat([acc * scale[..., None], (l * scale)[..., None]], dim=-1)
        both = self.all_reduce_sum(both)
        return both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-30)


class DataShards(Group):
    """The data axes ("pod", "data") of a mesh as an FSDP model sees them (a
    Group): the ranks of this rank's model index across those axes,
    pod-major, each holding its slice of every leaf that Placement.fsdp
    splits over them. ``scale``: the weight of this rank's gradient (its
    share of the global batch's target tokens), which the train step sets
    around its gradient pass; None weighs every rank 1."""

    def __init__(self, size: int = 1, rank: int = 0, group=None,
                 all_reduce: Callable | None = None):
        super().__init__(size, rank, group, all_reduce)
        self.scale = None

    def gather_leaf(self, x, dim: int):
        """A leaf's slice made whole over the data axes (the all-reduce of a
        zero-filled buffer). Backward: the whole cotangent times ``scale``,
        summed over the group, this rank keeping its slice (each rank uses
        the whole leaf on its own rows)."""
        if _graph(x):
            return _GatherLeaf.apply(x, self, dim % x.ndim)
        return self._gather(x, dim)

    def _reduce_slice(self, g, dim: int, n: int):
        g = g * self.scale if self.scale is not None else g.clone(
            memory_format=torch.contiguous_format)
        return self.all_reduce_sum(g).narrow(dim, self.offset(n), n).contiguous()


def _graph(*xs) -> bool:
    """Whether an op on ``xs`` is recorded by autograd."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        # on a copy: the graph's tensor may be saved for another node's backward
        return tp.all_reduce_sum(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        # on a copy: autograd may hand the same tensor to several branches
        return ctx.tp.all_reduce_sum(g.clone(memory_format=torch.contiguous_format)), None


class _RowsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp._rows_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return tp._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.offset(ctx.n), ctx.n).contiguous(), None, None


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, data, dim):
        ctx.data, ctx.dim, ctx.n = data, dim, x.shape[dim]
        return data._gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.data._reduce_slice(g, ctx.dim, ctx.n), None, None


class _ReduceTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, dim, *parts):
        ctx.tp, ctx.dim = tp, dim
        return tp._reduce_take(list(parts), dim)

    @staticmethod
    def backward(ctx, *gs):
        whole = ctx.tp._gather(torch.stack(gs), ctx.dim)
        return (None, None, *whole.unbind(0))


def widths(cfg, vocab_padded: int) -> dict:
    """Each logical axis of SPLIT_AXES at every width a leaf of the config
    has on it: the attention's (padded) query heads and its KV heads; the
    MLP's d_ff, the experts' moe_d_ff and the shared experts' moe_d_ff *
    n_shared_experts; the experts; the RG-LRU channels; the xLSTM heads,
    their projections (h * hd) and the sLSTM gates (4 * h * hd)."""
    hq = (cfg.heads_padded or cfg.n_heads) if cfg.attn_layout == "flat" else cfg.n_heads
    out: dict = {ax: set() for ax in SPLIT_AXES}
    out["vocab"].add(vocab_padded)
    if cfg.family == "ssm":
        hd = cfg.n_heads * cfg.hd
        out["qkv"] |= {hd, 4 * hd}
        out["heads"].add(cfg.n_heads)
    else:
        out["qkv"].add(hq * cfg.hd)
        out["kv"].add(cfg.n_kv_heads * cfg.hd)
    if cfg.d_ff:
        out["mlp"].add(cfg.d_ff)
    if cfg.family == "moe":
        out["experts"].add(cfg.n_experts)
        out["mlp"].add(cfg.moe_d_ff)
        if cfg.n_shared_experts:
            out["mlp"].add(cfg.moe_d_ff * cfg.n_shared_experts)
    if cfg.family == "hybrid":
        out["lru"].add(cfg.rglru_dim or cfg.d_model)
    return {ax: tuple(sorted(ws)) for ax, ws in out.items()}


def split(tp, axis: str, width: int) -> bool:
    """Whether a leaf's dim of logical ``axis`` at ``width`` is split over
    ``tp``'s group: the flag of that leaf's own placement (TP.split); False
    without a tp."""
    return tp is not None and tp.split.get((axis, width), False)


def flat_heads(n_heads: int, tp_size: int) -> int:
    """The flat layout's padded head count: H rounded up to a multiple of tp."""
    return math.ceil(n_heads / tp_size) * tp_size
