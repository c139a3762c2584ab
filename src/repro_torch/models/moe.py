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

Expert parallelism (a tp.TP on a mesh's "model" axis): the specs put
w1 / w3 / w2's experts dim on "model" where it divides (the first logical
dim wins, so each rank holds E/M whole experts), else each expert's "mlp"
dim where that divides, else nothing; the router is replicated. The
residual stream is replicated, so every rank routes every token alike.
With the experts split, each rank dispatches only the slots of its own
experts, at the global capacity and rank within the expert, so exactly
the unsharded dispatch's slots drop (a batch split over ("pod", "data")
counts the slots of earlier row blocks and takes the whole batch's
capacity: one all-reduce of each block's per-expert counts). It combines
its slots in ascending expert order (the others add zero) and one
all-reduce sums the ranks' partial outputs, the shared experts' partial
output (column- then row-parallel over "mlp") added first where it splits
too. No all-to-all. A layer whose leaves all stay whole issues no
collective.

Training on the mesh (tp.TP's autograd Functions): the partial outputs
are summed by tp.reduce; the tokens enter the rank's experts (tp.enter),
and so do the gates where the combine is partial, so each rank's router
gets the whole gradient of its gates. The router itself reads the tokens
un-entered: it is used alike on every rank (WHOLE in Model.grad_kinds),
and its aux loss, the same on every rank, counts once. Shared experts
held whole beside split experts read the tokens un-entered too.

The aux loss (load balance + 1e-3 z-loss) is returned as the reference
does, over the whole batch: a training forward whose batch is split into
row blocks sums the router's per-expert statistics over the blocks
(tp.TP.rows_sum) before it takes their product. ``drop_log()`` collects
the dropped-slot count of every sorted
dispatch run inside it, once a forward (on a mesh, each rank logs its
layer's global count once, the unsharded model's): a block recomputed
under remat in the backward does not count again; a replayed CUDA graph
appends the counts of its replay (repro_torch.graphs).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, ParamDef
from repro_torch.models.tp import split

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


def _batch_aux(p: dict, xt, idx, cfg, tp):
    """The aux loss of the whole batch of a split one (this rank's rows xt
    and their choices idx): each block's sums of the router probabilities,
    of the choices and of the squared log-sum-exp, summed over the row
    blocks (tp.TP.rows_sum), divided by the whole batch's tokens."""
    logits = (xt @ p["router"].to(COMPUTE_DTYPE)).float()
    e = cfg.n_experts
    sums = tp.rows_sum(torch.cat([
        torch.softmax(logits, dim=-1).sum(0), F.one_hot(idx, e).float().sum((0, 1)),
        (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]]))
    n = xt.shape[0] * tp.rows[0]
    me, ce, z = sums[:e] / n, sums[e:2 * e] / n, sums[2 * e] / n
    return e * torch.sum(me * ce) + 1e-3 * z


def capacity(n_tokens: int, cfg, capacity_factor: float) -> int:
    """Slots an expert takes: the mean load times the factor, rounded up to
    a multiple of 8, at least 8."""
    cap = int((n_tokens * cfg.top_k / cfg.n_experts) * capacity_factor + 0.5)
    return max(8, ((cap + 7) // 8) * 8)


def dispatch(idx, n_experts: int, cap: int, before=None):
    """The sorted dispatch of the (N, k) expert choices: (order, dest, keep)
    over the N*k slots sorted stably by expert. Slot i of the sorted order
    is slot order[i] of the flattened choices; it goes to buffer row
    dest[i] = expert * cap + rank within the expert, or is dropped (keep
    False, dest E*cap) past the expert's capacity. ``before`` (E,): each
    expert's slots that precede these in the batch (the rows of earlier
    ranks of a split batch), which the ranks within the expert start at."""
    nk = idx.numel()
    flat_e = idx.reshape(nk)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=idx.device),
                                side="left")
    rank = torch.arange(nk, device=idx.device) - starts[sorted_e]
    if before is not None:
        rank = rank + before[sorted_e]
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
                    log: bool = True, e0: int = 0, tp=None):
    """The sorted dispatch through experts e0 .. e0 + E_l - 1 (p's w1 / w3 /
    w2 hold E_l experts: all of them, or a rank's): the global dispatch,
    with the slots of other experts left out of the buffer and adding zero
    to the combine. Under a ``tp`` whose batch is split into row blocks,
    the capacity is the whole batch's and each slot's rank within its
    expert counts the slots of earlier blocks (TP.row_table), so the whole
    batch's slots drop."""
    n, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    e_l = p["w1"].shape[0]
    dt = COMPUTE_DTYPE
    before = None
    if tp is not None and tp.rows[0] > 1:
        flat = idx.reshape(-1)
        counts = torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        table = tp.row_table(counts)
        before = table[:tp.rows[1]].sum(0)
        cap = capacity(n * tp.rows[0], cfg, capacity_factor)
        dropped = torch.clamp_min(table.sum(0) - cap, 0).sum()
    else:
        cap = capacity(n, cfg, capacity_factor)
    order, dest, keep = dispatch(idx, e, cap, before)
    if _DROP_LOG is not None and log:
        log_drops([torch.sum(~keep) if before is None else dropped])
    if e_l != e:        # this rank's experts: rows e0 * cap .. of the global buffer
        keep = keep & (dest >= e0 * cap) & (dest < (e0 + e_l) * cap)
        dest = torch.where(keep, dest - e0 * cap, e_l * cap)
    tok = order // k                                # source token per slot
    # Slot j of token t sits at sorted position inv[t*k + j]; its expert
    # order is the order of the sorted slots.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    by_expert = torch.argsort(idx, dim=1)           # experts of a token are distinct
    at = inv.view(n, k).gather(1, by_expert)        # (N, k) ascending expert id

    buf = _Dispatch.apply(xt.to(dt), tok, dest, keep, at, e_l * cap)
    h = buf[:e_l * cap].view(e_l, cap, d)
    hidden = F.silu(torch.bmm(h, p["w1"].to(dt))) * torch.bmm(h, p["w3"].to(dt))
    out_flat = torch.bmm(hidden, p["w2"].to(dt)).reshape(e_l * cap, d)

    gate_slot = gates.reshape(-1)[order].to(dt)     # aligned with sorted slots
    contrib = out_flat[torch.where(keep, dest, 0)] * torch.where(
        keep, gate_slot, torch.zeros_like(gate_slot))[:, None]
    c = contrib[at]                                 # (N, k, D)
    y = torch.zeros((n, d), dtype=dt, device=xt.device)
    for j in range(k):
        y = y + c[:, j]
    return y


def _experts_dense(p: dict, xt, gates, idx, cfg, e0: int = 0):
    e, e_l = cfg.n_experts, p["w1"].shape[0]
    dt = COMPUTE_DTYPE
    # combine weights (N, E): sum of gate over the slots routed to e
    comb = torch.sum(F.one_hot(idx, e).float() * gates[..., None], dim=1)[:, e0:e0 + e_l]
    hidden = F.silu(torch.einsum("nd,edf->enf", xt, p["w1"].to(dt)))
    hidden = hidden * torch.einsum("nd,edf->enf", xt, p["w3"].to(dt))
    out = torch.einsum("enf,efd->end", hidden, p["w2"].to(dt))
    return torch.einsum("end,ne->nd", out, comb.to(dt))


def moe_apply(p: dict, x, cfg, impl: str = "sorted", capacity_factor: float = 1.25,
              log: bool = True, tp=None):
    """x: (B, S, D). Returns (y, aux_loss). ``log``: count the dispatch's
    dropped slots in an active drop_log (False for a remat recompute of a
    forward that counted them already). ``tp``: this rank's experts, or its
    columns of each expert, and its columns of the shared experts (module
    docstring); y is summed over the group where any of them split."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx, aux = _router(p, xt, cfg)
    if tp is not None and tp.rows[0] > 1 and torch.is_grad_enabled() \
            and p["router"].requires_grad:
        aux = _batch_aux(p, xt, idx, cfg, tp)
    e_split = split(tp, "experts", cfg.n_experts)
    partial = e_split or split(tp, "mlp", cfg.moe_d_ff)    # first logical dim wins
    s_split = bool(cfg.n_shared_experts) and split(
        tp, "mlp", cfg.moe_d_ff * cfg.n_shared_experts)
    e0 = tp.offset(p["w1"].shape[0]) if e_split else 0
    # the tokens enter once for the rank-local work (one sum of both parts'
    # cotangents); the router and whole shared experts read them as they are
    xe = tp.enter(xt) if partial or s_split else xt
    xd, gd = (xe, tp.enter(gates)) if partial else (xt, gates)
    if impl == "sorted":
        y = _experts_sorted(p, xd, gd, idx, cfg, capacity_factor, log, e0, tp)
    else:
        y = _experts_dense(p, xd, gd, idx, cfg, e0)
    if cfg.n_shared_experts:
        dt = COMPUTE_DTYPE
        xs = xe if s_split else xt
        h = F.silu(xs @ p["sw1"].to(dt)) * (xs @ p["sw3"].to(dt))
        shared = h @ p["sw2"].to(dt)
        if partial and not s_split:
            y, partial = tp.reduce(y), False
        elif s_split and not partial:
            shared = tp.reduce(shared)
        y = y + shared
    if partial:
        y = tp.reduce(y)
    return y.reshape(b, s, d), aux
