"""Model primitives: norms, RoPE, MLPs, embeddings, parameter descriptors.

Every parameter is described by a ParamDef. The JAX package stores float32
and casts at each use, to COMPUTE_DTYPE (bf16) for matmul weights,
embeddings and the conv, and keeps float32 for norms and the RG-LRU gates.
A serving model stores each parameter in the dtype it is used in (the def's
dtype), frozen: rounding to bf16 is deterministic, so storing the cast gives
the same numbers at half the memory. A model built for training stores
float32 masters that require grad, and each use casts them as the JAX
package does, with a differentiable cast (Tensor.to: its backward upcasts
the cotangent, as JAX transposes an astype). On stored bf16 the same cast
is the tensor itself, so serving runs the same ops.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.tp import DATA_AXES, dim_on, split
from repro_torch.pshard import local_slice

COMPUTE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple            # logical axis names, len == len(shape)
    init: str = "normal"   # normal | zeros | ones
    scale: float = 0.02
    dtype: torch.dtype = COMPUTE_DTYPE   # storage dtype


def _leaves(defs: dict, prefix: tuple = ()):
    for k, d in defs.items():
        if isinstance(d, dict):
            yield from _leaves(d, prefix + (k,))
        else:
            yield prefix + (k,), d


def init_params(defs: dict, generator: torch.Generator, n_stack: int = 0,
                dtype: torch.dtype | None = None) -> dict:
    """A nested dict of tensors for a nested dict of ParamDefs, drawn from
    ``generator`` (on its device) in float32 and stored in each def's dtype
    (or in ``dtype`` for every leaf: float32 masters). With n_stack > 0 a
    leading layers dimension of that size is added to every leaf."""
    device = generator.device
    out: dict = {}
    for path, d in _leaves(defs):
        shape = (n_stack, *d.shape) if n_stack else d.shape
        store = dtype or d.dtype
        if d.init == "zeros":
            arr = torch.zeros(shape, dtype=store, device=device)
        elif d.init == "ones":
            arr = torch.ones(shape, dtype=store, device=device)
        else:
            arr = torch.randn(shape, generator=generator, device=device).mul_(d.scale)
            arr = arr.to(store)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out


def param_specs(defs: dict) -> dict:
    """The logical axes of every leaf of a nested dict of ParamDefs."""
    return {k: param_specs(d) if isinstance(d, dict) else d.axes for k, d in defs.items()}


class Params(nn.Module):
    """A nested dict of ParamDefs as a module: sub-dicts become child Params,
    leaves nn.Parameters allocated (uninitialised) on ``device``: frozen in
    each def's dtype, or with ``trainable`` float32 masters that require
    grad. load_() fills them from a nested dict of tensors, casting to each
    leaf's storage dtype; tree() gives the nested dict of parameters.

    ``place`` (a tp.Placement, or None): each leaf is this rank's shard of
    its def, the slice pshard.spec_for assigns on the mesh; load_() cuts a
    leaf given whole to that slice. Under an FSDP placement (reshard_), a
    leaf whose "embed" dim splits over the data axes holds its slice of
    that dim as well, and gathered() / leaf() make it whole before use."""

    def __init__(self, defs: dict, device, trainable: bool = False, place=None):
        super().__init__()
        self.defs, self.place = defs, place
        self.data_dims: dict = {}   # leaf -> its dim split over the data axes (FSDP)
        for k, d in defs.items():
            if isinstance(d, dict):
                self.add_module(k, Params(d, device, trainable, place))
            else:
                shape = d.shape if place is None else place.local_shape(d.axes, d.shape)
                t = torch.empty(shape, dtype=torch.float32 if trainable else d.dtype,
                                device=device)
                self.register_parameter(k, nn.Parameter(t, requires_grad=trainable))

    @torch.no_grad()
    def load_(self, tree: dict, share: bool = False) -> "Params":
        """Copy ``tree`` in; with ``share``, a leaf that already is this
        rank's shard in the parameter's dtype becomes the parameter itself
        (no copy)."""
        for k, v in tree.items():
            if isinstance(v, dict):
                getattr(self, k).load_(v, share)
                continue
            dst, d = self._parameters[k], self.defs[k]
            if (self.place is not None and tuple(v.shape) == tuple(d.shape)
                    and tuple(dst.shape) != tuple(d.shape)):
                v = v[self.place.slice(d.axes, d.shape)]
            if tuple(v.shape) != tuple(dst.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)}, expected "
                                 f"{tuple(dst.shape)}")
            if share and v.dtype == dst.dtype:
                self._parameters[k] = nn.Parameter(v, requires_grad=dst.requires_grad)
            else:
                dst.copy_(v)
        return self

    def tree(self) -> dict:
        out: dict = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out

    @torch.no_grad()
    def reshard_(self, place) -> None:
        """Take ``place`` (this placement with fsdp on): each own leaf that it
        splits over the data axes becomes this rank's slice of its
        current shard (the dim is whole in that shard: an "embed" dim no
        other rule took). Child Params are resharded by their own call."""
        sizes, coord = place.sizes, place.coord
        for k, d in self.defs.items():
            if isinstance(d, dict):
                continue
            spec = place.spec(d.axes, d.shape)
            dim = dim_on(spec, DATA_AXES)
            if dim < 0:
                continue
            old = self._parameters[k]
            keep = tuple(e if i == dim else None for i, e in enumerate(spec))
            cut = old[local_slice(tuple(old.shape), keep, sizes, coord)]
            if cut.shape != old.shape:      # data axes of 1 keep the tensor itself
                self._parameters[k] = nn.Parameter(
                    cut.clone(memory_format=torch.contiguous_format),
                    requires_grad=old.requires_grad)
            self.data_dims[k] = dim
        self.place = place

    def leaf(self, k: str, data=None):
        """Parameter ``k``, made whole over the data axes (``data``, a
        tp.DataShards) where this rank holds its slice of them."""
        p = self._parameters[k]
        dim = self.data_dims.get(k, -1)
        return p if data is None or dim < 0 else data.gather_leaf(p, dim)

    def gathered(self, data=None) -> dict:
        """tree() with every leaf split over the data axes made whole (one
        gather a leaf: each is used once a call)."""
        if data is None:
            return self.tree()
        out = {k: self.leaf(k, data) for k in self._parameters}
        out.update({k: m.gathered(data) for k, m in self._modules.items()})
        return out


# ---------------------------------------------------------------------------
def rms_norm(x, w, eps: float = 1e-5):
    """Gemma's RMSNorm with a (1 + w) gain, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Rotary embedding with
    the two halves split (not interleaved); the frequencies are
    exp(-i * (log(theta) / half)) in float32, as the JAX package builds
    them."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    # a fill, not a copy from the host: a CUDA graph may capture this
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=x.device))
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                     * (log_theta / half))
    ang = positions[..., None].float() * freq            # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def at_use(w, x):
    """A weight as the JAX package uses it against activations x: cast to
    COMPUTE_DTYPE (a differentiable cast; the stored tensor itself when it
    already is), then widened to x's dtype where x is wider, as JAX promotes
    a mixed product (torch's matmul does not)."""
    w = w.to(COMPUTE_DTYPE)
    if x.dtype != w.dtype and torch.promote_types(x.dtype, w.dtype) == x.dtype:
        w = w.to(x.dtype)
    return w


def mlp_apply(p: dict, x, act: str, width: int, tp=None):
    """SwiGLU (w1/w3/w2) or GELU (w1/w2) MLP. GELU is the tanh form, the
    JAX default. Weights cast at use (at_use). With a tp.TP that splits
    "mlp" at ``width`` (the MLP's d_ff), w1 / w3 hold this rank's columns
    and w2 its rows: the input enters the rank's columns (tp.TP.enter) and
    the partial output is summed over the group (tp.TP.reduce); a
    replicated MLP is neither."""
    tp_split = split(tp, "mlp", width)
    if tp_split:
        x = tp.enter(x)
    if act == "swiglu":
        h = F.silu(x @ at_use(p["w1"], x)) * (x @ at_use(p["w3"], x))
    else:
        h = F.gelu(x @ at_use(p["w1"], x), approximate="tanh")
    out = h @ at_use(p["w2"], h)
    return tp.reduce(out) if tp_split else out


def mlp_defs(d_model: int, d_ff: int, act: str) -> dict:
    defs = {
        "w1": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w2": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }
    if act == "swiglu":
        defs["w3"] = ParamDef((d_model, d_ff), ("embed", "mlp"))
    return defs


def pad_vocab(v: int, multiple: int = 256) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def _vocab_split(tp, vocab: int) -> bool:
    return split(tp, "vocab", pad_vocab(vocab))


def embed_lookup(table, tokens, vocab: int, tp=None):
    """Rows of ``table`` at ``tokens``. Vocab-parallel under a tp.TP whose
    "vocab" is split: each rank looks up the tokens in its rows, writes
    zeros for the others, and the group sums (tp.TP.reduce: the table's
    gradient lands in the rank's rows only)."""
    if not _vocab_split(tp, vocab):
        return F.embedding(tokens, table).to(COMPUTE_DTYPE)
    n = table.shape[0]
    idx = tokens - tp.offset(n)
    mine = (idx >= 0) & (idx < n)
    rows = F.embedding(idx.clamp(0, n - 1), table)
    return tp.reduce(torch.where(mine[..., None], rows, 0).to(COMPUTE_DTYPE))


def logits_out(x, table, vocab: int, tp=None):
    """Project to the (padded) vocab in float32; mask the padding rows to
    -1e30. Under a tp.TP whose "vocab" is split, x enters the rank's
    columns (tp.TP.enter) and they are gathered whole (tp.TP.gather) before
    the mask."""
    vocab_split = _vocab_split(tp, vocab)
    if vocab_split:
        x = tp.enter(x)
    logits = (x @ table.to(COMPUTE_DTYPE).T).float()
    if vocab_split:
        logits = tp.gather(logits, -1)
    vp = logits.shape[-1]
    if vp != vocab:
        mask = torch.arange(vp, device=x.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    return logits
