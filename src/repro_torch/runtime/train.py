"""Training step: cross-entropy (optionally chunked) plus the MoE aux loss,
microbatch accumulation, global-norm clipping and AdamW, on one device.

The state is a TrainState of trees, as the JAX package's. Its params are
the model's own parameters (Model.param_tree(): float32 masters of a
Model(trainable=True)); a step computes the gradients with
torch.autograd.grad, clips them and runs AdamW in place
(clip_by_global_norm_ / adamw_update_: the JAX package's arithmetic, the
same bits as the pure functions), so the returned state holds the tensors
it was given, params and moments: the port's form of the JAX step's
donated state, at 16 bytes a parameter. A state whose params are other
tensors (a restored checkpoint) is copied into the model first.

jit_train_step and its ZeRO-1 shardings need a mesh, and wait for the port
of runtime/sharding (ROADMAP.md section 1, item 5).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import tree_flatten, tree_unflatten
from repro_torch.models import Model
from repro_torch.models.layers import logits_out
from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update_,
    clip_by_global_norm_,
    cosine_lr,
)


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
