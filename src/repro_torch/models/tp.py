"""Tensor parallelism over a mesh's "model" axis: the collectives that GSPMD
inserts for the JAX package's model-axis specs, written out.

The JAX package declares each parameter's logical axes and lets GSPMD
partition the program. The port places each leaf as the same specs say
(pshard.spec_for: a rank holds the slice pshard.local_slice gives it; a dim that
does not divide stays whole) and computes on plain local tensors, with the
reductions and gathers named here, on the mesh's "model" sub-group:

  all_reduce_sum / all_reduce_max   row-parallel matmuls, vocab-parallel
                                     embedding, the RG-LRU gates' partial
                                     products, the flash-decoding combine;
  gather_cols                        a last dim split over the ranks made
                                     whole (logits, K / V split inside a head,
                                     decode queries);
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
# The logical axes of the dense and hybrid families' parameters that the
# rules put on "model" (pshard.RULES); TP.split holds one flag each.
SPLIT_AXES = ("vocab", "qkv", "kv", "mlp", "lru")


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
    and the group's size, which logical axes are split over it (``split``:
    axis -> bool, each True where pshard.spec_for puts the axis on "model"
    at the model's width), and the all-reduce to use (``all_reduce(tensor,
    op=..., group=...)``, in place; torch.distributed.all_reduce unless
    given). A group of size 1 issues its collectives too, so they are
    captured where a mesh is given."""

    def __init__(self, size: int = 1, rank: int = 0, group=None, split: dict | None = None,
                 all_reduce: Callable | None = None):
        self.size, self.rank, self.group = int(size), int(rank), group
        self.split = {ax: False for ax in SPLIT_AXES}
        self.split.update(split or {})
        self._all_reduce = all_reduce

    @classmethod
    def on_mesh(cls, mesh, widths: dict, all_reduce: Callable | None = None) -> "TP":
        """The handle of this rank's "model" sub-group of ``mesh``; ``widths``
        maps each logical axis of SPLIT_AXES to the model's width on it."""
        sizes = mesh_shape(mesh)
        size = sizes.get(MODEL_AXIS, 1)
        split = {ax: spec_for(sizes, (ax,), (w,))[0] == MODEL_AXIS
                 for ax, w in widths.items()}
        return cls(size, mesh.get_local_rank(MODEL_AXIS), mesh.get_group(MODEL_AXIS),
                   split, all_reduce)

    def _reduce(self, x, op: str):
        import torch.distributed as dist
        x = x.contiguous()
        fn = self._all_reduce or dist.all_reduce
        fn(x, op=getattr(dist.ReduceOp, op), group=self.group)
        return x

    def all_reduce_sum(self, x):
        """x summed over the group (in place on x when contiguous)."""
        return self._reduce(x, "SUM")

    def all_reduce_max(self, x):
        return self._reduce(x, "MAX")

    def offset(self, n_local: int) -> int:
        """The first global index of this rank's slice of a split dim."""
        return self.rank * n_local

    def gather_cols(self, x):
        """A last dim split over the group made whole: each rank writes its
        slice into a zero-filled (..., n * size) buffer, then all-reduce."""
        n = x.shape[-1]
        buf = torch.zeros((*x.shape[:-1], n * self.size), dtype=x.dtype, device=x.device)
        buf[..., self.offset(n):self.offset(n) + n] = x
        return self.all_reduce_sum(buf)

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
    """Each logical axis of SPLIT_AXES at a dense or hybrid config's width."""
    hq = (cfg.heads_padded or cfg.n_heads) if cfg.attn_layout == "flat" else cfg.n_heads
    return {"vocab": vocab_padded, "qkv": hq * cfg.hd, "kv": cfg.n_kv_heads * cfg.hd,
            "mlp": cfg.d_ff, "lru": cfg.rglru_dim or cfg.d_model}


def flat_heads(n_heads: int, tp_size: int) -> int:
    """The flat layout's padded head count: H rounded up to a multiple of tp."""
    return math.ceil(n_heads / tp_size) * tp_size
