"""AdamW + cosine schedule, as plain functions on trees of tensors (nested
dicts, lists and named tuples; core.types.tree_map). Every function returns
new tensors and leaves its inputs as they are, as the JAX package's pure
functions do. The arithmetic is the JAX package's, operation by operation,
in float32: weight decay on every leaf (norms and biases included), the
bias corrections b ** t with t the step in float32, and an int32 step."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.types import tree_flatten, tree_map, tree_unflatten


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


def clip_by_global_norm(grads, max_norm=1.0):
    """grads scaled by min(1, max_norm / |grads|) and the global norm, the
    squares summed leaf by leaf in the tree's order (dict keys sorted, as
    jax.tree.leaves orders them)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_flatten(grads)[0]))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


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
