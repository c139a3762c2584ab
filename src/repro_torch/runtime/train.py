"""Training step: cross-entropy (optionally chunked) plus the MoE aux loss,
microbatch accumulation, global-norm clipping and AdamW, on one device
(make_train_step) or over a device mesh (jit_train_step).

The state is a TrainState of trees, as the JAX package's. Its params are
the model's own parameters (Model.param_tree(): float32 masters of a
Model(trainable=True)); a step computes the gradients with
torch.autograd.grad, clips them and runs AdamW in place
(clip_by_global_norm_ / adamw_update_: the JAX package's arithmetic, the
same bits as the pure functions), so the returned state holds the tensors
it was given, params and moments: the port's form of the JAX step's
donated state, at 16 bytes a parameter. A state whose params are other
tensors (a restored checkpoint) is copied into the model first.

A model built on a mesh (Model(cfg, mesh=, trainable=True), every family)
holds and steps its shard of every parameter and moment: its layers'
collectives are autograd Functions (models/tp.py), loss_and_grads sums the
gradients that are per-rank partials over the "model" axis
(Model.grad_kinds) and the global norm is the whole model's
(clip_by_global_norm_'s model_axis and data_axis). The logits are gathered
whole before the cross-entropy (a vocab-parallel log-softmax would save
that gather).

jit_train_step(model, mesh, ...) is the step on a ("data",), ("data",
"model") or ("pod", "data", "model") mesh, as the JAX package's production
meshes (16, 16) and (2, 16, 16) name them. A step takes the rank's rows of
the global batch (batch_spec over ("pod", "data"): the ranks of one data
index take the same rows), computes its gradients, sums them over the
data-parallel group (the ranks of its model index across ("pod", "data"))
so that every rank holds its shard of the gradient of the global batch's
loss (each rank's mean weighted by its share of the target tokens), clips
by the global norm of that gradient (the one-device step's order) and runs
AdamW. A MoE layer takes the whole batch's capacity and aux loss (the
batch's row blocks, tp.TP.rows), so a MoE model on data axes above 1 must
be built on the mesh.

With fsdp, every leaf whose "embed" dim no other rule took and divides
over ("pod", "data") (pshard.spec_for(fsdp=True)) is held, with its
moments and its update, as this rank's slice of that dim between steps
(Model.use_fsdp): each use gathers it whole over the data axes first, and
the gather's backward weighs the cotangent by the rank's token share,
sums it over them and keeps the rank's slice, so the step neither scales
nor sums that gradient again. With zero1, each rank keeps only its slice
of the moments of the leaves of at least 2^16 elements (the first
replicated dim of the whole leaf that divides over the data axes the leaf
does not already use, as the reference widens them: DTensors split over
them), updates its slice of those parameters, and the slices are
all-gathered over the data axes; an FSDP leaf's moments stay on its
shard. AdamW is elementwise and correctly rounded, so zero1 on and off
give the same bits, and a mesh of one device gives the bits of
make_train_step, with or without fsdp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import tree_flatten, tree_unflatten
from repro_torch.models import Model
from repro_torch.models import tp as tplib
from repro_torch.models.layers import logits_out
from repro_torch.models.model import PARTIAL, SPLIT
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update_,
    clip_by_global_norm_,
    cosine_lr,
)
from repro_torch.runtime import sharding as shlib



class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor      # int32 scalar


def init_state(model: Model, generator: torch.Generator) -> TrainState:
    """Draw the model's parameters from ``generator`` and start AdamW."""
    model.init(generator)
    params = model.param_tree()
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=model.device))


def attach(model: Model, state: TrainState) -> TrainState:
    """``state`` with the model's own parameters as its params, copying the
    state's values into them where they are other tensors."""
    mine = model.param_tree()
    if all(a is b for a, b in zip(tree_flatten(state.params)[0], tree_flatten(mine)[0],
                                  strict=True)):
        return state
    model.load_params_(state.params)
    return state._replace(params=mine)


def _nll_sum(logits, tgt):
    """(sum of -log p[target] over targets >= 0, their count), float32."""
    lp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, tgt.clamp_min(0).long()[..., None])[..., 0]
    mask = (tgt >= 0).float()
    return torch.sum(nll * mask), torch.sum(mask)


def loss_fn(model: Model, batch: dict, aux_weight=1e-2):
    """(loss + aux_weight * aux, (loss, aux)) with the (B, S, V) logits."""
    logits, _, aux = model.train_logits(batch)
    tot, cnt = _nll_sum(logits, batch["targets"])
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, (loss, aux)


def loss_fn_chunked(model: Model, batch: dict, aux_weight=1e-2, seq_chunk: int = 512):
    """loss_fn without the (B, S, V) float32 logits: the sequence is taken
    in chunks of seq_chunk, each chunk's logits computed under
    torch.utils.checkpoint, so its backward recomputes them (the JAX
    package's jax.checkpoint over a scan of chunks)."""
    hidden, aux = model.train_hidden(batch)
    tgt = batch["targets"]
    s = hidden.shape[1]
    c = min(seq_chunk, s)
    assert s % c == 0, (s, c)
    # gathered once (FSDP), its chunks' cotangents summed before its reduce
    unembed, vocab = model.top_leaf("unembed"), model.cfg.vocab_size

    def chunk_nll(h_c, t_c):
        return _nll_sum(logits_out(h_c, unembed, vocab, model.tp), t_c)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        h_c, t_c = hidden[:, i:i + c], tgt[:, i:i + c]
        if torch.is_grad_enabled():
            nll, m = checkpoint(chunk_nll, h_c, t_c, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            nll, m = chunk_nll(h_c, t_c)
        tot, cnt = tot + nll, cnt + m
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + aux_weight * aux, (loss, aux)


def loss_and_grads(model: Model, batch: dict, n_microbatches: int = 1, seq_chunk: int = 0,
                   aux_weight=1e-2):
    """(nll, aux, grads) of the loss (nll + aux_weight * aux) at the model's
    parameters: grads a tree shaped as Model.param_tree(). Microbatches
    split the batch on axis 0; their gradients are summed in order from
    zeros and divided by n, and so are nll and aux. On a model axis, the
    gradients that are per-rank partials (Model.grad_kinds: PARTIAL) are
    then summed over it, all in one all-reduce."""
    if seq_chunk:
        lfn = lambda b: loss_fn_chunked(model, b, aux_weight, seq_chunk)  # noqa: E731
    else:
        lfn = lambda b: loss_fn(model, b, aux_weight)  # noqa: E731
    leaves, treedef = tree_flatten(model.param_tree())

    def grad_fn(b):
        with torch.enable_grad():
            total, (nll, aux) = lfn(b)
            g = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
        return nll.detach(), aux.detach(), g

    if n_microbatches > 1:
        n = n_microbatches
        g_sum = [torch.zeros_like(p, memory_format=torch.contiguous_format) for p in leaves]
        nll_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            nll, aux, g = grad_fn(mb)
            g_sum = [a + b for a, b in zip(g_sum, g)]
            nll_sum, aux_sum = nll_sum + nll, aux_sum + aux
        g = [x / n for x in g_sum]
        nll, aux = nll_sum / n, aux_sum / n
    else:
        nll, aux, g = grad_fn(batch)
    g = list(g)
    if model.tp is not None:
        idx = [i for i, k in enumerate(model.grad_kinds()) if k == PARTIAL]
        if idx:
            flat = model.tp.all_reduce_sum(torch.cat([g[i].reshape(-1) for i in idx]))
            for i, part in zip(idx, flat.split([g[i].numel() for i in idx])):
                g[i] = part.view(g[i].shape)
    return nll, aux, tree_unflatten(treedef, g)


def model_axis(model: Model):
    """clip_by_global_norm_'s model_axis for a model on a mesh ((its tp.TP,
    each leaf's SPLIT flag)), or None."""
    if model.tp is None:
        return None
    return model.tp, [k == SPLIT for k in model.grad_kinds()]


def data_axis(model: Model):
    """clip_by_global_norm_'s data_axis for an FSDP model ((its
    tp.DataShards, each leaf's flag: split over the data axes)), or None."""
    if model.fsdp is None:
        return None
    return model.fsdp, [d >= 0 for d in model.data_dims()]


def make_train_step(model: Model, n_microbatches: int = 1, base_lr=3e-4, total_steps=10000,
                    seq_chunk: int = 0):
    """Returns train_step(state, batch) -> (state, metrics): the gradients
    (loss_and_grads; seq_chunk > 0 takes the chunked cross-entropy),
    clipped to global norm 1, the cosine learning rate at state.step and
    one AdamW update, in place. metrics: loss, aux, grad_norm, lr (device
    scalars). Every family trains: vlm and audio batches carry "frontend"."""
    if not model.trainable:
        raise ValueError("make_train_step needs a Model(trainable=True): float32 masters")
    axis = model_axis(model)

    def train_step(state: TrainState, batch: dict):
        state = attach(model, state)
        nll, aux, g = loss_and_grads(model, batch, n_microbatches, seq_chunk)
        g, gnorm = clip_by_global_norm_(g, model_axis=axis)
        lr = cosine_lr(state.step, base_lr=base_lr, total=total_steps)
        _, opt = adamw_update_(state.params, g, state.opt, lr)
        del g
        metrics = {"loss": nll, "aux": aux, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=state.params, opt=opt, step=state.step + 1), metrics

    return train_step


# --------------------------------------------------------------------------
# data parallel on a mesh
# --------------------------------------------------------------------------
def _dp_axes(mesh) -> tuple:
    return tuple(a for a in tplib.DATA_AXES if a in shlib.mesh_shape(mesh))


def _zero1_shardings(mesh, p_shard, params_shapes, min_size=2**16):
    """ZeRO-1: the optimizer moments of leaves of at least min_size elements
    additionally shard their first replicated dim that divides over the
    data-parallel axes that the leaf does not use already (widen). Returns
    the moments' tree of NamedSharding."""
    dp = _dp_axes(mesh)
    if not dp:
        return p_shard

    def widen(ns, arr):
        if arr.numel() < min_size:
            return ns
        spec = list(ns.spec) + [None] * (arr.ndim - len(ns.spec))
        used = {a for s in spec if s for a in (s if isinstance(s, tuple) else (s,))}
        free = tuple(a for a in dp if a not in used)
        if not free:
            return ns
        size = shlib.axis_size(mesh, free)
        for i, (ax, dim) in enumerate(zip(spec, arr.shape)):
            if ax is None and dim % size == 0 and dim >= size:
                spec[i] = free if len(free) > 1 else free[0]
                return shlib.NamedSharding(mesh, tuple(spec))
        return ns

    return shlib.map_shardings(widen, p_shard, params_shapes)


def _data_group(mesh, axes: tuple):
    """The process group of this rank's model index across the data axes
    ``axes`` (pod-major): the mesh's own sub-group where at most one of
    them is above 1; else one dist.new_group a model index, made on every
    rank in the same order (DeviceMesh gives a group a mesh dim only)."""
    import torch.distributed as dist
    sizes = shlib.mesh_shape(mesh)
    wide = [a for a in axes if sizes[a] > 1]
    if len(wide) <= 1:
        return mesh.get_group(wide[0] if wide else axes[-1])
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.permute(*[names.index(a) for a in names if a not in axes],
                              *[names.index(a) for a in axes])
    ranks = ranks.reshape(-1, shlib.axis_size(sizes, axes))
    mine = None
    for row in ranks.tolist():
        group = dist.new_group(row)
        if dist.get_rank() in row:
            mine = group
    return mine


class _DataParallel:
    """The rank's place on a data-parallel mesh: its group (the ranks of its
    "model" index across ("pod", "data"), _data_group), its index along
    those axes (pod-major, as tp.TP.rows orders the batch's row blocks)
    and their size."""

    def __init__(self, mesh):
        sizes = shlib.mesh_shape(mesh)
        self.mesh, self.axes = mesh, _dp_axes(mesh)
        if not self.axes:
            raise ValueError("a train step's mesh needs a 'data' axis (or 'pod')")
        self.size = shlib.axis_size(mesh, self.axes)
        self.index = 0
        for a in self.axes:
            self.index = self.index * sizes[a] + mesh.get_local_rank(a)
        self.group = _data_group(mesh, self.axes)

    def rows(self, x, what: str):
        """This rank's rows of a global batch leaf (a DTensor's local shard;
        a leaf already of the local size passes through)."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            return x.to_local()
        b = x.shape[0]
        if b % self.size:
            raise ValueError(f"batch leaf {what} of {b} rows does not split over the "
                             f"data-parallel axes {self.axes} ({self.size} ranks)")
        n = b // self.size
        return x[self.index * n:(self.index + 1) * n]

    def span(self, ns, shape) -> tuple[int, int, int] | None:
        """(dim, start, length) of this rank's slice of a leaf sharded by
        ``ns`` over the data axes, or None for a leaf held whole on them."""
        d = tplib.dim_on(ns.spec, self.axes)
        if d < 0:
            return None
        n = shape[d] // self.size
        return d, self.index * n, n

    def wrap(self, local, ns, shape):
        """A rank's slice as the DTensor of the whole leaf (no communication)."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, ns.placements, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    def gather_into(self, p, local, d: int) -> None:
        """All-gather the ranks' slices of dim d into the whole parameter p
        (straight into its rows when they are contiguous: d == 0)."""
        import torch.distributed as dist
        n = local.shape[d]
        rows = [p.narrow(d, i * n, n) for i in range(self.size)]
        if d == 0:
            dist.all_gather(rows, local, group=self.group)
            return
        parts = [torch.empty_like(local) for _ in range(self.size)]
        dist.all_gather(parts, local, group=self.group)
        for row, part in zip(rows, parts):
            row.copy_(part)


def _local_leaf(x, ns, shape: tuple, coord: dict):
    """This rank's part of a leaf of whole ``shape`` under ``ns``, from the
    leaf whole, from the rank's shard of the model axis alone (its data
    axes' dims still whole: a leaf before use_fsdp, or a moment before
    ZeRO-1 cut it), from the part itself or from a DTensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        if list(x.placements) != ns.placements:
            x = x.redistribute(ns.mesh, ns.placements)
        return x.to_local()
    sizes = shlib.mesh_shape(ns.mesh)
    want = shlib.local_shape(shape, ns.spec, sizes)
    if tuple(x.shape) == want:
        return x
    spec = ns.spec
    if tuple(x.shape) != shape:     # the model axis's shard: cut the data axes' dims
        spec = tuple(e if tplib.dim_on((e,), tplib.DATA_AXES) == 0 else None for e in spec)
    out = x[shlib.local_slice(tuple(x.shape), spec, sizes, coord)]
    if tuple(out.shape) != want:
        raise ValueError(f"a leaf of shape {tuple(x.shape)} is neither the whole {shape}, "
                         f"this rank's shard {want} nor its model axis's shard")
    return out.contiguous()


def _dp_loss_and_grads(model: Model, dp: _DataParallel, batch: dict, n_microbatches: int,
                       seq_chunk: int):
    """loss_and_grads of the rank's rows, then the global batch's (nll, aux,
    gradients) on every rank: each rank's mean is weighted by its share of
    the target tokens and the weighted gradients are summed over the
    data-parallel group (a share of 1 on a one-rank mesh: the same bits);
    an FSDP leaf's gradient comes weighted and summed, as its slice, from
    its gather's backward (model.fsdp.scale is the share meanwhile). A
    model whose batch is split into row blocks (built on the mesh)
    computes the MoE aux loss of the whole batch on every rank
    (moe._batch_aux), each rank's gradient of it its own rows' part: its
    weight is divided by the share, so that the weighted sum adds the
    parts, and its reading is the same on every rank."""
    import torch.distributed as dist
    local = {k: dp.rows(v, k) for k, v in batch.items()}
    cnt = torch.clamp((local["targets"] >= 0).sum().float(), min=1.0)
    total = cnt.clone()
    dist.all_reduce(total, group=dp.group)
    share = cnt / total
    whole_aux = model.tp is not None and model.tp.rows[0] > 1
    if model.fsdp is not None:
        model.fsdp.scale = share
    try:
        nll, aux, g = loss_and_grads(model, local, n_microbatches, seq_chunk,
                                     1e-2 / share if whole_aux else 1e-2)
    finally:
        if model.fsdp is not None:
            model.fsdp.scale = None
    held = [x for x, d in zip(tree_flatten(g)[0], model.data_dims(), strict=True) if d < 0]
    if held:
        torch._foreach_mul_(held, share)
    for x in held:
        dist.all_reduce(x, group=dp.group)
    # a whole-batch aux loss is counted once: the first row block's
    part = (aux if dp.index == 0 else torch.zeros_like(aux)) if whole_aux else aux * share
    readings = torch.stack([nll * share, part])
    dist.all_reduce(readings, group=dp.group)
    return readings[0], readings[1], g


def jit_train_step(model: Model, mesh, n_microbatches: int = 1, zero1: bool = False,
                   seq_chunk: int = 0, fsdp: bool = False):
    """The train step on ``mesh`` (module docstring). Returns (make,
    state_shard) as the reference does: make(batch_shapes) checks a global
    batch's shapes (a dict of tensors or shapes) against the mesh and
    returns step(state, batch) -> (state, metrics); state_shard is the
    TrainState of NamedSharding (params as tree_shardings places them,
    with fsdp the "embed" dims over the data axes too, the moments widened
    by ZeRO-1 when zero1). A model axis above 1, fsdp, or a MoE model on
    data axes above 1 needs the model built on ``mesh`` (Model(cfg,
    mesh=mesh, trainable=True)); fsdp shards it over the data axes
    (Model.use_fsdp), for good. step takes a TrainState of whole tensors,
    of this rank's shards (or its model axis's shards), or of DTensors (a
    restore with shardings=state_shard) and a batch of global leaves
    (every rank the same: it takes its rows), of DTensors, or of the
    rank's rows; it returns the params as the model's own shards, the
    moments that ZeRO-1 widens as DTensors of the whole leaf and the other
    moments as this rank's shards (convert.train_state_whole gathers a
    state whole)."""
    sizes = shlib.mesh_shape(mesh)
    wide = {a: n for a, n in sizes.items() if a not in ("pod", "data", "model") and n > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide} of more than one device: the train step runs on ('pod', "
            "'data', 'model') meshes (tensor-parallel over 'model', data-parallel and FSDP "
            "over ('pod', 'data')), the JAX package's")
    if not model.trainable:
        raise ValueError("jit_train_step needs a Model(trainable=True): float32 masters")
    dp_size = shlib.axis_size(mesh, _dp_axes(mesh))
    moe = any(sp.moe for sp in model.stages)
    why = ("a model axis above 1" if sizes.get("model", 1) > 1 else "fsdp" if fsdp
           else "a MoE model on data axes above 1 (its capacity and aux loss are the whole "
           "batch's)" if moe and dp_size > 1 else None)
    if why is not None and model.mesh is not mesh:
        raise ValueError(f"the model was not built on this mesh: Model(cfg, mesh=mesh, "
                         f"trainable=True), for {why}")
    if model.fsdp is not None and not fsdp:
        raise ValueError("the model holds FSDP shards (jit_train_step(fsdp=True)): a step "
                         "without FSDP needs another Model")
    dp = _DataParallel(mesh)
    if fsdp:
        model.use_fsdp(tplib.DataShards(dp.size, dp.index, dp.group,
                                        model.tp._all_reduce))
    whole_shapes = model.param_shapes()
    p_shard = shlib.tree_shardings(mesh, model.specs(), whole_shapes, fsdp=fsdp)
    m_shard = _zero1_shardings(mesh, p_shard, whole_shapes) if zero1 else p_shard
    scalar = shlib.NamedSharding(mesh, ())
    opt_shard = AdamWState(step=scalar, m=m_shard, v=m_shard)
    state_shard = TrainState(params=p_shard, opt=opt_shard, step=scalar)
    p_leaves, m_leaves = shlib.sharding_leaves(p_shard), shlib.sharding_leaves(m_shard)
    treedef = tree_flatten(model.param_tree())[1]
    shapes = [tuple(x.shape) for x in tree_flatten(whole_shapes)[0]]
    coord = tplib.mesh_coord(mesh)
    # ZeRO-1's slice of each widened leaf's shard (its dim is whole on the shard)
    spans = [None if mn.spec == pn.spec
             else dp.span(mn, shlib.local_shape(s, pn.spec, sizes))
             for pn, mn, s in zip(p_leaves, m_leaves, shapes, strict=True)]
    axis, d_axis = model_axis(model), data_axis(model)

    def local(tree, shardings):
        return [_local_leaf(x, ns, s, coord)
                for x, ns, s in zip(tree_flatten(tree)[0], shardings, shapes, strict=True)]

    def whole(xs):
        """Moment slices as the tree of their whole leaves."""
        return tree_unflatten(treedef, [x if at is None else dp.wrap(x, ns, s)
                                        for x, at, ns, s in zip(xs, spans, m_leaves, shapes)])

    def train_step(state: TrainState, batch: dict):
        state = TrainState(params=tree_unflatten(treedef, local(state.params, p_leaves)),
                           opt=state.opt, step=shlib.unshard(state.step))
        state = attach(model, state)
        m, v = local(state.opt.m, m_leaves), local(state.opt.v, m_leaves)
        nll, aux, g = _dp_loss_and_grads(model, dp, batch, n_microbatches, seq_chunk)
        g, gnorm = clip_by_global_norm_(g, model_axis=axis, data_axis=d_axis)
        lr = cosine_lr(state.step)
        p_leaves_now = tree_flatten(state.params)[0]
        p_loc = [p if at is None else p.narrow(*at).contiguous()   # a view at dim 0
                 for p, at in zip(p_leaves_now, spans)]
        g_loc = [x if at is None else x.narrow(*at) for x, at in zip(tree_flatten(g)[0], spans)]
        _, opt = adamw_update_(p_loc, g_loc, AdamWState(
            step=shlib.unshard(state.opt.step), m=m, v=v), lr)
        del g, g_loc
        with torch.no_grad():
            for p, loc, at in zip(p_leaves_now, p_loc, spans):
                if at is not None:
                    dp.gather_into(p, loc, at[0])
        opt = AdamWState(step=opt.step, m=whole(opt.m), v=whole(opt.v))
        metrics = {"loss": nll, "aux": aux, "grad_norm": gnorm, "lr": lr}
        return TrainState(params=state.params, opt=opt, step=state.step + 1), metrics

    def make(batch_shapes):
        for k, x in batch_shapes.items():
            shape = tuple(getattr(x, "shape", x))
            if shlib.batch_spec(mesh, shape)[0] is None or shape[0] % dp.size:
                raise ValueError(f"batch leaf {k} {shape} does not split over the "
                                 f"data-parallel axes {dp.axes} ({dp.size} ranks)")
        return train_step

    return make, state_shard
