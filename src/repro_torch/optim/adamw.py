"""AdamW + cosine schedule, as plain functions on trees of tensors (nested
dicts, lists and named tuples; core.types.tree_map). The pure functions
return new tensors and leave their inputs as they are, as the JAX package's
do. The arithmetic is the JAX package's, operation by operation, in
float32: weight decay on every leaf (norms and biases included), the bias
corrections b ** t with t the step in float32, and an int32 step.

adamw_update_ and clip_by_global_norm_ do the same arithmetic in place,
leaf by leaf, in flat chunks of at most CHUNK elements (an elementwise
operation gives the same bits in chunks): a train step then holds the
params, their gradients and the two moments, 16 bytes a parameter, and a
chunk's temporaries, where the pure pair holds new moments and params
beside the old ones and a clipped copy of every gradient."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.types import tree_flatten, tree_map, tree_unflatten

CHUNK = 1 << 26     # elements of a leaf the in-place functions take at once


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    m: dict
    v: dict


def _map(fn, *trees):
    """fn over trees of one structure, leaf by leaf (in tree_flatten order)."""
    leaves = [tree_flatten(t)[0] for t in trees]
    return tree_unflatten(tree_flatten(trees[0])[1],
                          [fn(*xs) for xs in zip(*leaves, strict=True)])


def adamw_init(params) -> AdamWState:
    """Zero moments shaped as params, and step 0 (int32 on their device)."""
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_lr(step, base_lr=3e-4, warmup=100, total=10000, min_frac=0.1):
    """Linear warmup to base_lr over ``warmup`` steps, then a cosine decay
    to min_frac * base_lr at ``total``; a float32 scalar tensor."""
    step = step.float()
    warm = base_lr * step / max(1, warmup)
    prog = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = min_frac * base_lr + (1 - min_frac) * base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def _clip_scale(grads, max_norm):
    """(min(1, max_norm / |grads|), |grads|): the squares summed leaf by leaf
    in the tree's order (dict keys sorted, as jax.tree.leaves orders them)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_flatten(grads)[0]))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm=1.0):
    """grads scaled by min(1, max_norm / |grads|), and the global norm."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm=1.0):
    """clip_by_global_norm writing the scaled gradients into ``grads``'
    leaves; returns (grads, the global norm). The same bits."""
    scale, gn = _clip_scale(grads, max_norm)
    for g in tree_flatten(grads)[0]:
        for c in _chunks(g):
            c.mul_(scale)
    return grads, gn


def _chunks(t):
    """Views of a tensor's elements, CHUNK at a time (the tensor itself when
    it is not contiguous)."""
    if not t.is_contiguous():
        return [t]
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """One AdamW step: (new params, new AdamWState). Builds no autograd
    graph, whether or not the params require grad."""
    step = state.step + 1
    t = step.float()
    m = _map(lambda a, g: b1 * a + (1 - b1) * g, state.m, grads)
    v = _map(lambda a, g: b2 * a + (1 - b2) * g * g, state.v, grads)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, mm, vv):
        mh = mm / c1
        vh = vv / c2
        return p - lr * (mh / (torch.sqrt(vh) + eps) + wd * p)

    new_params = _map(upd, params, m, v)
    return new_params, AdamWState(step=step, m=m, v=v)


@torch.no_grad()
def adamw_update_(params, grads, state: AdamWState, lr, b1=0.9, b2=0.95, eps=1e-8, wd=0.1):
    """adamw_update writing the new params into ``params``' leaves and the
    new moments into ``state``'s, leaf by leaf and chunk by chunk, with the
    same operations in the same order (the same bits). Returns (params, the
    new AdamWState: a new step, the same m and v tensors). The params and
    moments must be contiguous."""
    step = state.step + 1
    t = step.float()
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    leaves = [tree_flatten(x)[0] for x in (params, grads, state.m, state.v)]
    for p, g, m, v in zip(*leaves, strict=True):
        g = g.contiguous()
        for pc, gc, mc, vc in zip(*(_chunks(x) for x in (p, g, m, v)), strict=True):
            mc.mul_(b1).add_((1 - b1) * gc)
            vc.mul_(b2).add_((1 - b2) * gc * gc)
            pc.sub_(lr * (mc / c1 / (torch.sqrt(vc / c2) + eps) + wd * pc))
    return params, AdamWState(step=step, m=state.m, v=state.v)
