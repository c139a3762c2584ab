"""QoS monitor: latency percentiles + deadline misses -> replan trigger.

Tracks completed-request latencies in a fixed-size ring on the device and
maintains per-user deadline-miss EMAs. Every epoch it produces p50/p95 over
the window and a *device boolean* trigger that fires when either
percentile or the miss rate crosses its threshold; the closed loop reads
that one scalar per epoch and, when set, forces a planner replan with the
current measured profile. Hysteresis (``cooldown_epochs``) keeps a noisy
boundary from re-triggering every epoch.

The reference pushes completions into the ring and folds the miss EMAs
with sequential scans over the B slots. The ring push is a prefix sum
here (the r-th valid completion lands at (head + r) mod W; when more than
W complete in one epoch only the last W land, as the scan leaves them).
The EMA fold stays a loop over the B slots, in slot order, since a user
can complete in two slots of one epoch; each pass is tensor code, with no
host read.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.types import Tensor
from repro_torch.device import resolve_device
from repro_torch.online.batcher import Completions


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Thresholds are in seconds (percentiles) / fraction (miss rate).
    ``window`` is the latency-ring depth; ``miss_decay`` the per-completion
    EMA factor for per-user deadline misses."""

    deadline_s: float = 0.5
    p95_max_s: float = 0.5
    p50_max_s: float = 0.25
    miss_rate_max: float = 0.05
    window: int = 256
    miss_decay: float = 0.9
    cooldown_epochs: int = 10
    # Harden the monitor against corrupt latencies (fault injection): a
    # non-finite latency counts as a deadline miss and enters the ring as a
    # breaching-but-finite sentinel. Without this, one NaN latency poisons
    # the percentile ring: every comparison against it is False and the
    # QoS trigger goes silently blind.
    guard_nonfinite: bool = False


class QosState(NamedTuple):
    lat: Tensor        # (W,) latency ring
    valid: Tensor      # (W,) bool: ring entry holds a real completion
    head: Tensor       # () int32 next write position
    miss: Tensor       # (U,) per-user deadline-miss EMA
    served: Tensor     # () int32 completions seen
    missed: Tensor     # () int32 deadline misses seen
    good: Tensor       # () int32 finite, in-deadline completions (goodput)
    cooldown: Tensor   # () int32 epochs until the trigger can re-fire
    triggers: Tensor   # () int32 times the trigger fired


class QosReport(NamedTuple):
    """Per-epoch snapshot, all device scalars. ``trigger`` is the one value
    the loop reads on the host."""

    p50: Tensor
    p95: Tensor
    miss_rate: Tensor
    trigger: Tensor    # () bool


def qos_update(cfg: QosConfig, state: QosState,
               comp: Completions) -> tuple[QosState, QosReport]:
    """Pure one-epoch update."""
    w = state.lat.shape[0]
    i32 = torch.int32
    finite = torch.isfinite(comp.latency)
    good = state.good + torch.sum(
        comp.valid & finite & (comp.latency <= cfg.deadline_s)).to(i32)
    latency = comp.latency
    if cfg.guard_nonfinite:
        # Corrupt latencies become a finite sentinel that is guaranteed to
        # breach (and a miss, below): the monitor reacts instead of going
        # blind on NaN comparisons.
        sentinel = torch.full_like(latency, 2.0 * max(cfg.p95_max_s, cfg.deadline_s))
        latency = torch.where(finite, latency, sentinel)

    # Ring-write this epoch's completions (at most B of them).
    rank = torch.cumsum(comp.valid.to(torch.int64), 0) - 1
    n_new = torch.sum(comp.valid).to(torch.int64)
    lands = comp.valid & (rank >= n_new - w)
    pos = torch.where(lands, (state.head.to(torch.int64) + rank) % w,
                      torch.full_like(rank, w))
    lat = torch.cat([state.lat, state.lat.new_zeros(1)]).scatter(0, pos, latency)[:w]
    valid = torch.cat([state.valid, state.valid.new_zeros(1)]).scatter(
        0, pos, torch.ones_like(comp.valid))[:w]
    head = state.head + n_new.to(i32)

    # Per-user deadline-miss EMA, one step per completing slot, in slot order.
    late = comp.valid & (latency > cfg.deadline_s)
    users = torch.arange(state.miss.shape[0], device=state.miss.device)
    uid = torch.clamp_min(comp.user, 0)
    miss = state.miss
    for b in range(comp.valid.shape[0]):
        old = miss.gather(0, uid[b:b + 1].to(torch.int64))
        new = cfg.miss_decay * old + (1.0 - cfg.miss_decay) * late[b:b + 1].to(torch.float32)
        miss = torch.where(comp.valid[b] & (users == uid[b]), new, miss)

    served = state.served + torch.sum(comp.valid).to(i32)
    missed = state.missed + torch.sum(late).to(i32)

    # Percentiles over valid ring entries only: invalid slots are pushed to
    # +inf and the percentile rank is rescaled to the valid count.
    n_valid = torch.sum(valid).to(i32)
    filled = torch.where(valid, lat, torch.full_like(lat, float("inf")))
    ranked = torch.sort(filled).values
    frac = torch.clamp_min(n_valid - 1, 0).to(torch.float32)
    idx50 = torch.round(0.50 * frac).to(torch.int64).reshape(1)
    idx95 = torch.round(0.95 * frac).to(torch.int64).reshape(1)
    any_valid = n_valid > 0
    zero = torch.zeros((), dtype=torch.float32, device=lat.device)
    p50 = torch.where(any_valid, ranked.gather(0, idx50)[0], zero)
    p95 = torch.where(any_valid, ranked.gather(0, idx95)[0], zero)
    miss_rate = torch.where(served > 0,
                            missed.to(torch.float32) / torch.clamp_min(served, 1), zero)

    breach = any_valid & ((p95 > cfg.p95_max_s) | (p50 > cfg.p50_max_s)
                          | (miss_rate > cfg.miss_rate_max))
    armed = state.cooldown <= 0
    trigger = breach & armed
    cooldown = torch.where(trigger, torch.full_like(state.cooldown, cfg.cooldown_epochs),
                           torch.clamp_min(state.cooldown - 1, 0))

    new = QosState(lat=lat, valid=valid, head=head, miss=miss, served=served,
                   missed=missed, good=good, cooldown=cooldown,
                   triggers=state.triggers + trigger.to(i32))
    return new, QosReport(p50=p50, p95=p95, miss_rate=miss_rate, trigger=trigger)


class QosMonitor:
    """device: None resolves to the card and raises without CUDA."""

    def __init__(self, cfg: QosConfig, n_users: int, device=None):
        if cfg.window < 2:
            raise ValueError(f"window must be >= 2, got {cfg.window}")
        self.cfg = cfg
        self.n_users = int(n_users)
        self.device = resolve_device(device)

    def init(self) -> QosState:
        w, dev, i32 = self.cfg.window, self.device, torch.int32
        return QosState(
            lat=torch.zeros((w,), dtype=torch.float32, device=dev),
            valid=torch.zeros((w,), dtype=torch.bool, device=dev),
            head=torch.zeros((), dtype=i32, device=dev),
            miss=torch.zeros((self.n_users,), dtype=torch.float32, device=dev),
            served=torch.zeros((), dtype=i32, device=dev),
            missed=torch.zeros((), dtype=i32, device=dev),
            good=torch.zeros((), dtype=i32, device=dev),
            cooldown=torch.zeros((), dtype=i32, device=dev),
            triggers=torch.zeros((), dtype=i32, device=dev),
        )

    def update(self, state: QosState, comp: Completions) -> tuple[QosState, QosReport]:
        """Fold one epoch's completions in."""
        return qos_update(self.cfg, state, comp)
