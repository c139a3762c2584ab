"""Training step: cross-entropy (optionally chunked) plus the MoE aux loss,
microbatch accumulation, global-norm clipping and AdamW, on one device
(make_train_step) or data-parallel over a device mesh (jit_train_step).

The state is a TrainState of trees, as the JAX package's. Its params are
the model's own parameters (Model.param_tree(): float32 masters of a
Model(trainable=True)); a step computes the gradients with
torch.autograd.grad, clips them and runs AdamW in place
(clip_by_global_norm_ / adamw_update_: the JAX package's arithmetic, the
same bits as the pure functions), so the returned state holds the tensors
it was given, params and moments: the port's form of the JAX step's
donated state, at 16 bytes a parameter. A state whose params are other
tensors (a restored checkpoint) is copied into the model first.

jit_train_step(model, mesh, ...) is the data-parallel step on a mesh whose
axes other than ("pod", "data") are all of size 1 (a "model" axis above 1,
and fsdp, wait for TP / FSDP training: ROADMAP.md section 1, the sharding
item's tensor-parallel half; serving has the model axis, models/tp.py). Every rank holds the whole parameters. A step
takes the rank's rows of the global batch (batch_spec over ("pod",
"data")), computes its gradients, all-reduces them over the data-parallel
group so that every rank holds the whole gradient of the global batch's
loss (each rank's mean weighted by its share of the target tokens), clips
by the global norm of that gradient (the one-device step's order) and runs
AdamW. With zero1, each rank keeps only its slice of the moments of the
leaves of at least 2^16 elements (the first replicated dim that divides,
as the reference widens them: DTensors split over the data axes), updates
its slice of those parameters, and the slices are all-gathered. AdamW is
elementwise and correctly rounded, so zero1 on and off give the same bits,
and a mesh of one device gives the bits of make_train_step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import tree_flatten, tree_unflatten
from repro_torch.models import Model
from repro_torch.models.layers import logits_out
from repro_torch.models.model import TP_ITEM
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
    unembed, vocab = model.top.unembed, model.cfg.vocab_size

    def chunk_nll(h_c, t_c):
        return _nll_sum(logits_out(h_c, unembed, vocab), t_c)

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


def loss_and_grads(model: Model, batch: dict, n_microbatches: int = 1, seq_chunk: int = 0):
    """(nll, aux, grads) of the loss at the model's parameters: grads a tree
    shaped as Model.param_tree(). Microbatches split the batch on axis 0;
    their gradients are summed in order from zeros and divided by n, and so
    are nll and aux."""
    if seq_chunk:
        lfn = lambda b: loss_fn_chunked(model, b, seq_chunk=seq_chunk)  # noqa: E731
    else:
        lfn = lambda b: loss_fn(model, b)  # noqa: E731
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
    return nll, aux, tree_unflatten(treedef, list(g))


def make_train_step(model: Model, n_microbatches: int = 1, base_lr=3e-4, total_steps=10000,
                    seq_chunk: int = 0):
    """Returns train_step(state, batch) -> (state, metrics): the gradients
    (loss_and_grads; seq_chunk > 0 takes the chunked cross-entropy),
    clipped to global norm 1, the cosine learning rate at state.step and
    one AdamW update, in place. metrics: loss, aux, grad_norm, lr (device
    scalars). Every family trains: vlm and audio batches carry "frontend"."""
    if not model.trainable:
        raise ValueError("make_train_step needs a Model(trainable=True): float32 masters")

    def train_step(state: TrainState, batch: dict):
        state = attach(model, state)
        nll, aux, g = loss_and_grads(model, batch, n_microbatches, seq_chunk)
        g, gnorm = clip_by_global_norm_(g)
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
    return tuple(a for a in ("pod", "data") if a in shlib.mesh_shape(mesh))


def _zero1_shardings(mesh, p_shard, params_shapes, min_size=2**16):
    """ZeRO-1: the optimizer moments of leaves of at least min_size elements
    additionally shard their first replicated dim that divides over the
    data-parallel axes (widen). Returns the moments' tree of NamedSharding."""
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


class _DataParallel:
    """The rank's place on a data-parallel mesh: its group, its index along
    the ("pod", "data") axes (pod-major) and their size."""

    def __init__(self, mesh):
        import torch.distributed as dist
        sizes = shlib.mesh_shape(mesh)
        self.mesh, self.axes = mesh, _dp_axes(mesh)
        self.size = shlib.axis_size(mesh, self.axes)
        self.index = 0
        for a in self.axes:
            self.index = self.index * sizes[a] + mesh.get_local_rank(a)
        if len(self.axes) == 1:
            self.group = mesh.get_group(self.axes[0])
        elif mesh.size() == dist.get_world_size():
            self.group = None          # the other axes are 1: every rank of the world
        else:
            raise ValueError("a ('pod', 'data') mesh must span the process group")

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
        ``ns`` over the data axes, or None for a replicated leaf."""
        for d, entry in enumerate(ns.spec):
            if set(entry if isinstance(entry, tuple) else (entry,)) & set(self.axes):
                n = shape[d] // self.size
                return d, self.index * n, n
        return None

    def local(self, x, ns):
        """This rank's part of a moment leaf under ``ns``: a DTensor's local
        shard, a whole tensor's slice (contiguous), or the whole tensor."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            if list(x.placements) != ns.placements:
                x = x.redistribute(self.mesh, ns.placements)
            return x.to_local()
        at = self.span(ns, x.shape)
        return x if at is None else x.narrow(*at).contiguous()

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


def _dp_loss_and_grads(model: Model, dp: _DataParallel, batch: dict, n_microbatches: int,
                       seq_chunk: int):
    """loss_and_grads of the rank's rows, then the global batch's (nll, aux,
    gradients) on every rank: each rank's mean is weighted by its share of
    the target tokens and the weighted gradients are summed over the
    data-parallel group (a share of 1 on a one-rank mesh: the same bits)."""
    import torch.distributed as dist
    local = {k: dp.rows(v, k) for k, v in batch.items()}
    nll, aux, g = loss_and_grads(model, local, n_microbatches, seq_chunk)
    cnt = torch.clamp((local["targets"] >= 0).sum().float(), min=1.0)
    total = cnt.clone()
    dist.all_reduce(total, group=dp.group)
    share = cnt / total
    g_leaves = tree_flatten(g)[0]
    torch._foreach_mul_(g_leaves, share)
    for x in g_leaves:
        dist.all_reduce(x, group=dp.group)
    readings = torch.stack([nll, aux]) * share
    dist.all_reduce(readings, group=dp.group)
    return readings[0], readings[1], g


def jit_train_step(model: Model, mesh, n_microbatches: int = 1, zero1: bool = False,
                   seq_chunk: int = 0, fsdp: bool = False):
    """The data-parallel train step on ``mesh`` (module docstring). Returns
    (make, state_shard) as the reference does: make(batch_shapes) checks a
    global batch's shapes (a dict of tensors or shapes) against the mesh and
    returns step(state, batch) -> (state, metrics); state_shard is the
    TrainState of NamedSharding (params replicated, the moments widened by
    ZeRO-1 when zero1). step takes a TrainState of whole tensors or of this
    rank's shards (DTensors: a restore with shardings=state_shard) and a
    batch of global leaves (every rank the same: it takes its rows), of
    DTensors, or of the rank's rows; it returns the moments that ZeRO-1
    shards as DTensors (pshard.unshard gathers them) and the rest whole."""
    if fsdp:
        raise NotImplementedError(f"fsdp=True waits for {TP_ITEM}")
    sizes = shlib.mesh_shape(mesh)
    wide = {a: n for a, n in sizes.items() if a not in ("pod", "data") and n > 1}
    if wide:
        raise NotImplementedError(f"mesh axes {wide} of more than one device wait for "
                                  f"{TP_ITEM}")
    if not model.trainable:
        raise ValueError("jit_train_step needs a Model(trainable=True): float32 masters")
    dp = _DataParallel(mesh)
    params_shapes = model.param_tree()
    p_shard = shlib.tree_shardings(mesh, model.specs(), params_shapes, fsdp=fsdp)
    m_shard = _zero1_shardings(mesh, p_shard, params_shapes) if zero1 else p_shard
    scalar = shlib.NamedSharding(mesh, ())
    opt_shard = AdamWState(step=scalar, m=m_shard, v=m_shard)
    state_shard = TrainState(params=p_shard, opt=opt_shard, step=scalar)
    m_leaves = shlib.sharding_leaves(m_shard)
    leaves, treedef = tree_flatten(params_shapes)
    shapes = [tuple(p.shape) for p in leaves]
    spans = [dp.span(ns, shape) for ns, shape in zip(m_leaves, shapes, strict=True)]

    def whole(xs):
        """Moment slices as the tree of their whole leaves."""
        return tree_unflatten(treedef, [x if at is None else dp.wrap(x, ns, s)
                                        for x, at, ns, s in zip(xs, spans, m_leaves, shapes)])

    def train_step(state: TrainState, batch: dict):
        state = TrainState(params=shlib.unshard(state.params), opt=state.opt,
                           step=shlib.unshard(state.step))
        state = attach(model, state)
        m, v = ([dp.local(x, ns) for x, ns in zip(tree_flatten(t)[0], m_leaves, strict=True)]
                for t in (state.opt.m, state.opt.v))
        nll, aux, g = _dp_loss_and_grads(model, dp, batch, n_microbatches, seq_chunk)
        g, gnorm = clip_by_global_norm_(g)
        lr = cosine_lr(state.step)
        p_leaves = tree_flatten(state.params)[0]
        p_loc = [p if at is None else p.narrow(*at).contiguous()   # a view at dim 0
                 for p, at in zip(p_leaves, spans)]
        g_loc = [x if at is None else x.narrow(*at) for x, at in zip(tree_flatten(g)[0], spans)]
        _, opt = adamw_update_(p_loc, g_loc, AdamWState(
            step=shlib.unshard(state.opt.step), m=m, v=v), lr)
        del g, g_loc
        with torch.no_grad():
            for p, loc, at in zip(p_leaves, p_loc, spans):
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
