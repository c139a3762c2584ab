"""Tensor parallelism over a mesh's "model" axis: the collectives that GSPMD
inserts for the JAX package's model-axis specs, written out.

The JAX package declares each parameter's logical axes and lets GSPMD
partition the program. The port places each leaf as the same specs say
(pshard.spec_for: a rank holds the slice pshard.local_slice gives it; a dim that
does not divide stays whole) and computes on plain local tensors, with the
reductions and gathers named here, on the mesh's "model" sub-group:

  all_reduce_sum / all_reduce_max   row-parallel matmuls, vocab-parallel
                                     embedding, the RG-LRU gates' partial
                                     products, the MoE's partial combine over
                                     a rank's experts, the flash-decoding
                                     combine;
  gather / gather_cols               a dim split over the ranks made whole
                                     (logits, K / V split inside a head,
                                     decode queries, projections whose split
                                     cuts heads, the xLSTM states' layouts);
  lse_combine                        the ranks' partial softmax attention over
                                     their cache slots merged into one.

Every collective is an all-reduce: a gather is the all-reduce of a
zero-filled whole buffer in which each rank writes its slice. So one code
path runs on NCCL, on gloo over CPU tensors and on gloo over CUDA tensors
(which takes all_reduce but not all_gather). The handle takes its
all-reduce as an argument (``torch.distributed.all_reduce`` by default), so
a caller may stage it through the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.pshard import local_shape, local_slice, mesh_shape, spec_for

MODEL_AXIS = "model"
# The logical axes of the parameters that the rules put on "model"
# (pshard.RULES). One axis may take several widths in one model (MoE:
# "mlp" at d_ff, moe_d_ff and the shared experts'; xLSTM: "qkv" at h * hd
# and 4 * h * hd), which need not all divide the axis: TP.split holds a flag
# for each (axis, width) that widths() lists.
SPLIT_AXES = ("vocab", "qkv", "kv", "mlp", "lru", "experts", "heads")


def mesh_coord(mesh) -> dict[str, int]:
    """This rank's coordinate on each named dim of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a rank sits on a mesh: the axis sizes and its coordinate. A
    parameter def's spec is pshard.spec_for of its logical axes and full
    shape; its local shape and slice follow."""

    sizes: dict
    coord: dict

    @classmethod
    def on(cls, mesh) -> "Placement":
        return cls(mesh_shape(mesh), mesh_coord(mesh))

    def spec(self, axes: tuple, shape: tuple) -> tuple:
        return spec_for(self.sizes, axes, tuple(shape))

    def local_shape(self, axes: tuple, shape: tuple) -> tuple:
        return local_shape(tuple(shape), self.spec(axes, shape), self.sizes)

    def slice(self, axes: tuple, shape: tuple) -> tuple:
        return local_slice(tuple(shape), self.spec(axes, shape), self.sizes, self.coord)


class TP:
    """The model axis as the layers see it: the sub-group, this rank's index
    and the group's size, which leaves are split over it (``split``: (axis,
    width) -> bool, True where pshard.spec_for puts a leaf's dim of that
    logical axis and width on "model"; the function split() reads it), which
    xLSTM state leaves the caches hold split on their last dim
    (``state_split``: key -> bool, from runtime.sharding.cache_shardings; the
    model fills it), and the all-reduce to use (``all_reduce(tensor, op=...,
    group=...)``, in place; torch.distributed.all_reduce unless given). A
    group of size 1 issues its collectives too, so they are captured where a
    mesh is given."""

    def __init__(self, size: int = 1, rank: int = 0, group=None, split: dict | None = None,
                 all_reduce: Callable | None = None, rows: tuple = (1, 0),
                 state_split: dict | None = None):
        self.size, self.rank, self.group = int(size), int(rank), group
        self.split = dict(split or {})
        self.state_split = dict(state_split or {})
        self._all_reduce = all_reduce
        # (count, index) of the batch's row blocks over ("pod", "data")
        self.rows = tuple(rows)

    @classmethod
    def on_mesh(cls, mesh, widths: dict, all_reduce: Callable | None = None) -> "TP":
        """The handle of this rank's "model" sub-group of ``mesh``; ``widths``
        maps each logical axis of SPLIT_AXES to the model's widths on it
        (widths())."""
        sizes = mesh_shape(mesh)
        size = sizes.get(MODEL_AXIS, 1)
        split = {(ax, w): spec_for(sizes, (ax,), (w,))[0] == MODEL_AXIS
                 for ax, ws in widths.items() for w in ws}
        coord = mesh_coord(mesh)
        count, index = 1, 0
        for ax in ("pod", "data"):
            if ax in sizes:
                count, index = count * sizes[ax], index * sizes[ax] + coord[ax]
        return cls(size, mesh.get_local_rank(MODEL_AXIS), mesh.get_group(MODEL_AXIS),
                   split, all_reduce, (count, index))

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

    def gather(self, x, dim: int = -1):
        """A dim split over the group made whole: each rank writes its slice
        into a zero-filled buffer n * size long on ``dim``, then all-reduce
        (adding zeros changes no value)."""
        dim %= x.ndim
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.size
        buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
        buf.narrow(dim, self.offset(n), n).copy_(x)
        return self.all_reduce_sum(buf)

    def gather_cols(self, x):
        """The last dim split over the group made whole (gather)."""
        return self.gather(x, -1)

    def take(self, x, dim: int = -1):
        """This rank's slice of a whole dim that splits over the group."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.offset(n), n)

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
