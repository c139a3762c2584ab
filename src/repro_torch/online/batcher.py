"""Continuous batching on the edge decode path.

The edge serves a fixed-capacity batch of B request *slots*: arrivals are
enqueued into a bounded FIFO ring, free slots are refilled from the queue
head every epoch (admit), and one batched edge step serves every active
slot at once (tick): edge throughput scales with concurrency instead of
serializing per request. Everything is tensor code over a single
BatchState on the device; admission, eviction and completion accounting
are prefix sums, gathers and selects, so the hot path never reads the host.

The reference runs ``enqueue`` and ``admit`` as sequential scans (over the
U*K arrival candidates and over the B slots). Both are prefix sums here:
- enqueue: the r-th valid candidate (user-major order) fits iff
  r < Q - size and lands at ring position (head + size + r) mod Q; the
  rest count as ``dropped``;
- admit: the r-th free slot pops the queue entry at (head + r) mod Q iff
  r < size. A popped head whose user is flagged ``shed`` is counted and
  leaves its slot free for this epoch.

Two consumers:

* The planning-only closed loop (repro_torch.online.loop) drives the
  queueing core alone: per-request service time comes from the measured
  delay model and occupancy converts to slot epochs.
* Real split serving: ``DecodeBatcher`` keeps one capacity-sized KV/state
  cache (Model.make_caches) alive across requests, writes a per-request
  prefill into its slot at admission (slot_update), and advances every
  active slot with one masked decode step per epoch (inactive slots'
  caches are frozen via slot_where and overwritten at their next
  admission). ``EdgeBatcher`` is the single-shot analogue over stacked
  split activations for the paper's CNN-style one-pass inference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import Tensor, host_copies, tree_flatten, tree_unflatten
from repro_torch.device import resolve_device


class BatchState(NamedTuple):
    """Slots + FIFO ring + counters; all device tensors, static shapes."""

    # slots (capacity B)
    active: Tensor    # (B,) bool
    user: Tensor      # (B,) int32, -1 when free
    t_arr: Tensor     # (B,) f32 arrival time (s) of the occupying request
    wait: Tensor      # (B,) f32 queue wait (s) accrued before admission
    serv: Tensor      # (B,) f32 modeled service seconds of the request
    work: Tensor      # (B,) int32 remaining edge steps
    # FIFO ring (depth Q)
    q_user: Tensor    # (Q,) int32
    q_t: Tensor       # (Q,) f32 arrival times
    q_head: Tensor    # () int32
    q_size: Tensor    # () int32
    # counters
    dropped: Tensor   # () int32 arrivals rejected on a full ring
    completed: Tensor  # () int32 requests fully served
    shed: Tensor      # () int32 requests shed by the degradation ladder
                      # (admission control under faults; 0 when disabled)


class Completions(NamedTuple):
    """Per-epoch completion record, fixed shape (B,): at most one request
    per slot completes per tick."""

    valid: Tensor     # (B,) bool
    user: Tensor      # (B,) int32
    latency: Tensor   # (B,) f32 end-to-end seconds (wait + service)
    wait: Tensor      # (B,) f32 queue-wait component
    serv: Tensor      # (B,) f32 service component


def init_state(capacity: int, queue_depth: int, device=None) -> BatchState:
    b, q = int(capacity), int(queue_depth)
    dev = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return BatchState(
        active=z((b,), torch.bool), user=torch.full((b,), -1, dtype=i32, device=dev),
        t_arr=z((b,), f32), wait=z((b,), f32), serv=z((b,), f32), work=z((b,), i32),
        q_user=torch.full((q,), -1, dtype=i32, device=dev), q_t=z((q,), f32),
        q_head=z((), i32), q_size=z((), i32),
        dropped=z((), i32), completed=z((), i32), shed=z((), i32))


def _rank(mask: Tensor) -> Tensor:
    """0-based rank of each set element among the set ones (int64)."""
    return torch.cumsum(mask.to(torch.int64), 0) - 1


def enqueue(state: BatchState, counts: Tensor, now: Tensor,
            max_per_user: int) -> BatchState:
    """Append this epoch's arrivals (per-user counts, capped at
    ``max_per_user``) to the FIFO ring; overflow increments ``dropped``.
    ``now`` is a () float32 tensor."""
    u = counts.shape[0]
    q = state.q_user.shape[0]
    k = int(max_per_user)
    dev = counts.device
    # (U, K) candidate grid flattened in user-major order: request j of user
    # i exists iff j < counts[i].
    valid = (torch.arange(k, device=dev)[None, :] < counts[:, None]).reshape(-1)
    users = torch.arange(u, dtype=torch.int32, device=dev)[:, None].expand(u, k).reshape(-1)
    rank = _rank(valid)
    fits = valid & (rank < (q - state.q_size).to(torch.int64))
    # Fitting candidates land at distinct ring positions; the others write a
    # scratch position Q that is cut off after the scatter.
    pos = torch.where(fits, (state.q_head.to(torch.int64) + state.q_size + rank) % q,
                      torch.full_like(rank, q))
    q_user = torch.cat([state.q_user, state.q_user.new_zeros(1)]).scatter(0, pos, users)[:q]
    q_t = torch.cat([state.q_t, state.q_t.new_zeros(1)]).scatter(
        0, pos, now.to(torch.float32).expand(pos.shape[0]))[:q]
    n_fit = torch.sum(fits).to(torch.int32)
    return state._replace(q_user=q_user, q_t=q_t, q_size=state.q_size + n_fit,
                          dropped=state.dropped + torch.sum(valid & ~fits).to(torch.int32))


def admit(state: BatchState, now: Tensor, service_s: Tensor, work_steps: Tensor,
          shed: Tensor | None = None) -> BatchState:
    """Refill free slots from the queue head (FIFO). ``service_s``: (U,)
    modeled service seconds per user at the current operating point;
    ``work_steps``: (U,) int32 slot epochs the request will occupy.

    ``shed`` (optional, (U,) bool) is the degradation ladder's admission
    gate: a queue head whose user is flagged is popped and counted into
    ``state.shed`` instead of occupying a slot (under a persistent deep
    fade its modeled work would pin the slot for ``max_work_epochs``,
    starving every healthy user behind it). None keeps the ungated
    behavior."""
    q = state.q_user.shape[0]
    free = ~state.active
    rank = _rank(free)
    pop = free & (rank < state.q_size.to(torch.int64))
    at = ((state.q_head.to(torch.int64) + torch.clamp_min(rank, 0)) % q)
    uid = state.q_user.gather(0, at)
    t0 = state.q_t.gather(0, at)
    uidx = torch.clamp_min(uid, 0).to(torch.int64)
    doomed = pop & shed.gather(0, uidx) if shed is not None else torch.zeros_like(pop)
    take = pop & ~doomed
    nowf = now.to(torch.float32)
    n_pop = torch.sum(pop).to(torch.int32)
    return state._replace(
        active=state.active | take,
        user=torch.where(take, uid, state.user),
        t_arr=torch.where(take, t0, state.t_arr),
        wait=torch.where(take, nowf - t0, state.wait),
        serv=torch.where(take, service_s.gather(0, uidx), state.serv),
        work=torch.where(take, work_steps.gather(0, uidx), state.work),
        q_head=(state.q_head + n_pop) % q,
        q_size=state.q_size - n_pop,
        shed=state.shed + torch.sum(doomed).to(torch.int32),
    )


def tick(state: BatchState) -> tuple[BatchState, Completions]:
    """One batched edge step: every active slot advances one unit of work;
    slots reaching zero complete and free."""
    work = state.work - state.active.to(torch.int32)
    done = state.active & (work <= 0)
    zero = torch.zeros_like(state.wait)
    comp = Completions(
        valid=done,
        user=torch.where(done, state.user, torch.full_like(state.user, -1)),
        latency=torch.where(done, state.wait + state.serv, zero),
        wait=torch.where(done, state.wait, zero),
        serv=torch.where(done, state.serv, zero),
    )
    state = state._replace(
        active=state.active & ~done,
        user=torch.where(done, torch.full_like(state.user, -1), state.user),
        work=torch.clamp_min(work, 0),
        completed=state.completed + torch.sum(done).to(torch.int32),
    )
    return state, comp


def occupancy(state: BatchState) -> Tensor:
    """() int32: active slots (the edge batch's instantaneous load)."""
    return torch.sum(state.active).to(torch.int32)


def backlog(state: BatchState) -> Tensor:
    """() int32: requests waiting in the ring behind the batch."""
    return state.q_size


class ContinuousBatcher:
    """The queueing core as one per-epoch step:
    ``step(state, counts, now, service_s, work_steps)`` runs
    enqueue -> admit -> tick and returns (state', completions).
    device: None resolves to the card and raises without CUDA."""

    def __init__(self, capacity: int, queue_depth: int, max_per_user_epoch: int,
                 device=None):
        if capacity < 1 or queue_depth < 1:
            raise ValueError(
                f"capacity/queue_depth must be >= 1, got "
                f"{capacity}/{queue_depth}")
        self.capacity = int(capacity)
        self.queue_depth = int(queue_depth)
        self.max_per_user_epoch = int(max_per_user_epoch)
        self.device = resolve_device(device)

    def init(self) -> BatchState:
        return init_state(self.capacity, self.queue_depth, self.device)

    def step(self, state: BatchState, counts: Tensor, now: Tensor,
             service_s: Tensor, work_steps: Tensor) -> tuple[BatchState, Completions]:
        state = enqueue(state, counts, now, self.max_per_user_epoch)
        state = admit(state, now, service_s, work_steps)
        return tick(state)


# --------------------------------------------------------------------------
# real-model edge batching: slot-masked steps over the serving caches
# --------------------------------------------------------------------------
# The port's caches are {"stages": [{"kv": {...}} | {"rglru": {...}} | None],
# "pos": (B,)} and, for the audio / vlm families, "enc_out" / "frontend"
# (B, Sf, D). A stage cache's leaves are stacked over the stage's layers
# first, (L, B, ...), so their slot axis is 1; the other leaves lead with B.
# A stage without a cache (cross, encoder) is None, and stays None.
def _map_caches(fn, caches: dict, *others: dict) -> dict:
    """fn(leaf, *other leaves, slot_axis) over a cache tree and trees of its
    structure."""
    def rec(x, ys, ax):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: rec(x[k], [y[k] for y in ys], ax) for k in x}
        if isinstance(x, list):
            return [rec(a, [y[i] for y in ys], ax) for i, a in enumerate(x)]
        return fn(x, *ys, ax)
    return {k: rec(v, [o[k] for o in others], 1 if k == "stages" else 0)
            for k, v in caches.items()}


def slot_update(caches: dict, slot: int | Tensor, one: dict) -> dict:
    """Write a single-request cache tree (batch dim 1, e.g. from
    Model.prefill at batch 1) into slot ``slot`` of a capacity-sized cache:
    the decode-cache analogue of admitting a request."""
    def write(full, single, ax):
        idx = torch.as_tensor(slot, dtype=torch.int64, device=full.device).reshape(1)
        return full.index_copy(ax, idx, single.to(full.dtype))
    return _map_caches(write, caches, one)


def slot_where(active: Tensor, new: dict, old: dict) -> dict:
    """Per-slot select over a cache tree: active slots take ``new``,
    inactive keep ``old`` (frozen until their next admission)."""
    def sel(n, o, ax):
        shape = [1] * n.ndim
        shape[ax] = active.shape[0]
        return torch.where(active.reshape(shape), n, o)
    return _map_caches(sel, new, old)


class EdgeBatcher:
    """Single-shot split inference over stacked activations: admitted
    requests write their device-side activation into a (B, S, D) buffer;
    one edge_fn call per epoch serves every active slot (masked-slot
    continuous batching: inactive lanes compute garbage that is never
    read, the standard slot-batching tradeoff). device: None resolves to
    the card and raises without CUDA."""

    def __init__(self, capacity: int, seq: int, d_model: int,
                 dtype=torch.float32, device=None):
        self.capacity = int(capacity)
        self.buf = torch.zeros((capacity, seq, d_model), dtype=dtype,
                               device=resolve_device(device))

    def write(self, buf: Tensor, slot: int | Tensor, act: Tensor) -> Tensor:
        """Insert one request's (S, D) (or (1, S, D)) activation at slot."""
        if act.ndim == 3:
            act = act[0]
        idx = torch.as_tensor(slot, dtype=torch.int64, device=buf.device).reshape(1)
        return buf.index_copy(0, idx, act.to(buf.dtype)[None])

    def run(self, edge_fn, buf: Tensor) -> Tensor:
        """One batched edge pass over the whole buffer: (B, S, vocab)."""
        return edge_fn(buf)


class DecodeBatcher:
    """Edge decode path with per-slot KV/state caches: one capacity-sized
    cache from Model.make_caches, a per-request prefill written into its
    slot at admission, one masked decode step per epoch for all active
    slots. ``params`` stays in the reference's position and must be None:
    the port's Model holds its own weights. The prefill runs the model's
    kernels (flash_attention and rg_lru on the card); a decode step is
    plain tensor code."""

    def __init__(self, model, params, capacity: int, max_len: int):
        if params is not None:
            raise ValueError("the port's Model holds its own weights: pass params=None")
        self.model = model
        self.params = params
        self.capacity = int(capacity)
        self.max_len = int(max_len)
        self.caches = model.make_caches(capacity, max_len)

    @torch.no_grad()
    def admit(self, slot: int, tokens: Tensor) -> Tensor:
        """Prefill one request (tokens (1, S)) into ``slot``; returns its
        next-token logits (vocab,)."""
        logits, one = self.model.prefill({"tokens": tokens}, self.max_len)
        self.caches = slot_update(self.caches, slot, one)
        return logits[0]

    @torch.no_grad()
    def step(self, token: Tensor, active: Tensor) -> Tensor:
        """One masked decode step: token (B, 1), active (B,) bool ->
        logits (B, vocab). Every active slot advances together; inactive
        slots' caches are frozen and their logits lanes are garbage by
        contract."""
        token = torch.where(active[:, None], token, torch.zeros_like(token))
        logits, new_caches = self.model.decode_step(self.caches, token)
        self.caches = slot_where(active, new_caches, self.caches)
        return logits

    def export_caches(self):
        """Host copies of the slot caches (a serving snapshot's batcher
        leg), taken on the caller's thread with one sync: never a view of
        the live caches."""
        flat, treedef = tree_flatten(self.caches)
        return tree_unflatten(treedef, host_copies(flat))

    def import_caches(self, caches) -> None:
        """Restore exported slot caches onto the live caches' device. The
        structure, shapes and dtypes must match the live caches (same
        model / capacity / max_len); a mismatch raises ValueError naming the
        leaf."""
        live, live_def = tree_flatten(self.caches)
        new, new_def = tree_flatten(caches)
        if new_def != live_def:
            raise ValueError(f"cache treedef mismatch on import: got {new_def}, live "
                             f"caches are {live_def}")
        for i, (a, b) in enumerate(zip(new, live)):
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(f"cache leaf {i}: got {a.dtype}{list(a.shape)}, live "
                                 f"caches have {b.dtype}{list(b.shape)}")
        self.caches = tree_unflatten(live_def, [a.to(b.device, copy=True)
                                                for a, b in zip(new, live)])
