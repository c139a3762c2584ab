"""Mixture-of-Experts layer: top-k routing with shared experts.

Two implementations, selectable via `impl`, as the JAX package's:

  * "sorted" (default): sort-based token dispatch -- token slots are sorted
    (stably) by expert id, written into a capacity-bounded (E, C, D) buffer,
    run through batched expert matmuls, and combined. Slots past an
    expert's capacity are dropped, the same slots as the reference's.
  * "dense": every expert runs on every token, combined with the routing
    weights; the oracle the sorted path is tested against.

The expert products are plain batched matmuls (torch.bmm / einsum): the
JAX package computes them as einsums, outside any Pallas kernel.

Two places where a direct translation would give other answers:
  * top-k with ties: jax.lax.top_k puts the lower index first, torch.topk
    promises no order; _top_k takes the first k columns of a stable
    descending sort.
  * the combine: the reference scatter-adds each token's k contributions in
    the order of the sorted slots (ascending expert id). index_add_ would
    sum with atomics on the card, in no fixed order; _experts_sorted
    gathers the k contributions of each token and adds them one at a time
    from zero in that order, so two runs give the same bits. The
    dispatch's backward, which sums a token's k slot gradients, does the
    same (_Dispatch).

The aux loss (load balance + 1e-3 z-loss) is returned as the reference
does. ``drop_log()`` collects the dropped-slot count of every sorted
dispatch run inside it, once a forward: a block recomputed under remat in
the backward does not count again; a replayed CUDA graph appends the counts
of its replay (repro_torch.graphs).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, ParamDef

_DROP_LOG: list | None = None


@contextlib.contextmanager
def drop_log():
    """Collect, for every sorted dispatch inside the block, its count of
    dropped slots as a device int64 scalar (read them after the block)."""
    global _DROP_LOG
    prev, _DROP_LOG = _DROP_LOG, []
    try:
        yield _DROP_LOG
    finally:
        _DROP_LOG = prev


def log_drops(counts: list) -> None:
    """Append dropped-slot counts to the active drop_log, if any."""
    if _DROP_LOG is not None:
        _DROP_LOG.extend(counts)


def moe_defs(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", "experts_row")),
        "w1": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "w3": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "w2": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        defs["sw1"] = ParamDef((d, fs), ("embed", "mlp"))
        defs["sw3"] = ParamDef((d, fs), ("embed", "mlp"))
        defs["sw2"] = ParamDef((fs, d), ("mlp", "embed"))
    return defs


def _top_k(probs, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p: dict, xt, cfg):
    """Returns (gates (N, k) float32, idx (N, k) int64, aux_loss ())."""
    logits = (xt @ p["router"].to(COMPUTE_DTYPE)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    # Switch-style load-balance loss + router z-loss
    e = cfg.n_experts
    me = torch.mean(probs, dim=0)                                  # (E,)
    ce = torch.mean(torch.sum(F.one_hot(idx, e).float(), dim=1), dim=0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, idx, lb + 1e-3 * z


def capacity(n_tokens: int, cfg, capacity_factor: float) -> int:
    """Slots an expert takes: the mean load times the factor, rounded up to
    a multiple of 8, at least 8."""
    cap = int((n_tokens * cfg.top_k / cfg.n_experts) * capacity_factor + 0.5)
    return max(8, ((cap + 7) // 8) * 8)


def dispatch(idx, n_experts: int, cap: int):
    """The sorted dispatch of the (N, k) expert choices: (order, dest, keep)
    over the N*k slots sorted stably by expert. Slot i of the sorted order
    is slot order[i] of the flattened choices; it goes to buffer row
    dest[i] = expert * cap + rank within the expert, or is dropped (keep
    False, dest E*cap) past the expert's capacity."""
    nk = idx.numel()
    flat_e = idx.reshape(nk)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=idx.device),
                                side="left")
    rank = torch.arange(nk, device=idx.device) - starts[sorted_e]
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank, n_experts * cap)
    return order, dest, keep


class _Dispatch(torch.autograd.Function):
    """The sorted dispatch buf[dest] = xt[tok] into a (rows + 1, D) buffer
    (the last row takes every dropped slot), with a backward that sums each
    token's k slots without atomics: the slots' gradients gathered through
    ``at`` (the sorted positions of a token's slots, ascending expert id)
    and added one at a time from zero in that order, as the combine adds
    them in its forward. Two backward passes give the same bits."""

    @staticmethod
    def forward(ctx, xt, tok, dest, keep, at, rows: int):
        buf = xt.new_zeros((rows + 1, xt.shape[1]))
        buf[dest] = xt[tok]
        ctx.save_for_backward(dest, keep, at)
        return buf

    @staticmethod
    def backward(ctx, dbuf):
        dest, keep, at = ctx.saved_tensors
        g = torch.where(keep[:, None], dbuf[dest], torch.zeros((), dtype=dbuf.dtype,
                                                               device=dbuf.device))
        c = g[at]                                       # (N, k, D)
        dx = torch.zeros_like(c[:, 0])
        for j in range(c.shape[1]):
            dx = dx + c[:, j]
        return dx, None, None, None, None, None


def _experts_sorted(p: dict, xt, gates, idx, cfg, capacity_factor: float = 1.25,
                    log: bool = True):
    n, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = COMPUTE_DTYPE
    cap = capacity(n, cfg, capacity_factor)
    order, dest, keep = dispatch(idx, e, cap)
    if _DROP_LOG is not None and log:
        log_drops([torch.sum(~keep)])
    tok = order // k                                # source token per slot
    # Slot j of token t sits at sorted position inv[t*k + j]; its expert
    # order is the order of the sorted slots.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    by_expert = torch.argsort(idx, dim=1)           # experts of a token are distinct
    at = inv.view(n, k).gather(1, by_expert)        # (N, k) ascending expert id

    buf = _Dispatch.apply(xt.to(dt), tok, dest, keep, at, e * cap)
    h = buf[:e * cap].view(e, cap, d)
    hidden = F.silu(torch.bmm(h, p["w1"].to(dt))) * torch.bmm(h, p["w3"].to(dt))
    out_flat = torch.bmm(hidden, p["w2"].to(dt)).reshape(e * cap, d)

    gate_slot = gates.reshape(-1)[order].to(dt)     # aligned with sorted slots
    contrib = out_flat[torch.where(keep, dest, 0)] * torch.where(
        keep, gate_slot, torch.zeros_like(gate_slot))[:, None]
    c = contrib[at]                                 # (N, k, D)
    y = torch.zeros((n, d), dtype=dt, device=xt.device)
    for j in range(k):
        y = y + c[:, j]
    return y


def _experts_dense(p: dict, xt, gates, idx, cfg):
    e = cfg.n_experts
    dt = COMPUTE_DTYPE
    # combine weights (N, E): sum of gate over the slots routed to e
    comb = torch.sum(F.one_hot(idx, e).float() * gates[..., None], dim=1)
    hidden = F.silu(torch.einsum("nd,edf->enf", xt, p["w1"].to(dt)))
    hidden = hidden * torch.einsum("nd,edf->enf", xt, p["w3"].to(dt))
    out = torch.einsum("enf,efd->end", hidden, p["w2"].to(dt))
    return torch.einsum("end,ne->nd", out, comb.to(dt))


def moe_apply(p: dict, x, cfg, impl: str = "sorted", capacity_factor: float = 1.25,
              log: bool = True):
    """x: (B, S, D). Returns (y, aux_loss). ``log``: count the dispatch's
    dropped slots in an active drop_log (False for a remat recompute of a
    forward that counted them already)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx, aux = _router(p, xt, cfg)
    if impl == "sorted":
        y = _experts_sorted(p, xt, gates, idx, cfg, capacity_factor, log)
    else:
        y = _experts_dense(p, xt, gates, idx, cfg)
    if cfg.n_shared_experts:
        dt = COMPUTE_DTYPE
        h = F.silu(xt @ p["sw1"].to(dt)) * (xt @ p["sw3"].to(dt))
        y = y + h @ p["sw2"].to(dt)
    return y.reshape(b, s, d), aux
