"""Request streams: per-user Poisson arrivals driving the closed loop.

A RequestStream turns a time-evolving scenario population into per-epoch
split-inference request traffic. Each user slot carries an independent
Poisson arrival process (rate ``arrival_rate_hz`` while its *session* is
active); sessions themselves churn with the same slot-replacement semantics
as ``repro_torch.scenarios.churn`` (a replaced slot is a user leaving and a
new one joining mid-session), so offered load breathes the way a live
cell's does while every tensor keeps its static (U,) shape.

Randomness is counter-based: epoch t's draws come from a generator seeded
by (seed, t) alone (``scenarios.scenario.fold_in``), so any epoch's traffic
can be replayed without replaying the stream. The step splits into its
draws (``step_draws``: the Poisson counts before the cap, and the churn
and fresh-session uniforms) and a deterministic core (``stream_step_from``);
a Bernoulli(p) is ``uniform < p``. The epoch counter is a Python int, so
seeding reads nothing from the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.types import Tensor
from repro_torch.device import resolve_device
from repro_torch.scenarios import churn
from repro_torch.scenarios.scenario import fold_in


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Traffic knobs. ``arrival_rate_hz`` is per *active* user; a request's
    service demand is ``tokens_per_request`` edge decode steps; its deadline
    is ``deadline_s`` after arrival. ``session_churn_hz`` replaces user
    sessions wholesale (scenarios.churn slot-replacement semantics);
    ``duty_cycle`` is the long-run fraction of sessions that are active.
    ``max_per_user_epoch`` caps one slot's arrivals per epoch so downstream
    queues can size statically."""

    arrival_rate_hz: float = 4.0
    epoch_dt_s: float = 0.1
    tokens_per_request: int = 8
    deadline_s: float = 0.5
    session_churn_hz: float = 0.0
    duty_cycle: float = 1.0
    max_per_user_epoch: int = 4


class StreamState(NamedTuple):
    session: Tensor  # (U,) bool: slot currently running an active session
    epoch: int       # epochs stepped (the draws' counter)
    offered: Tensor  # () int32 total requests offered so far


def _f32(x: float, device) -> Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=device)


def step_draws(cfg: StreamConfig, n_users: int, gen: torch.Generator) -> dict:
    """One epoch's draws: Poisson(rate * dt) counts before the cap (int32),
    and, with session churn, the replacement and fresh-session uniforms."""
    dev = gen.device
    lam = torch.full((n_users,), cfg.arrival_rate_hz * cfg.epoch_dt_s,
                     dtype=torch.float32, device=dev)
    draws = {"counts": torch.poisson(lam, generator=gen).to(torch.int32)}
    if cfg.session_churn_hz > 0.0:
        draws["churn"] = torch.rand((n_users,), generator=gen, device=dev)
        draws["fresh"] = torch.rand((n_users,), generator=gen, device=dev)
    return draws


def stream_step_from(cfg: StreamConfig, n_users: int, draws: dict,
                     state: StreamState) -> tuple[StreamState, Tensor]:
    """Pure one-epoch step on the epoch's draws: (new state, per-user
    arrival counts (U,) int32)."""
    session = state.session
    if cfg.session_churn_hz > 0.0:
        replaced = churn.mask_from(draws["churn"], n_users, cfg.session_churn_hz,
                                   cfg.epoch_dt_s)
        fresh = draws["fresh"] < _f32(cfg.duty_cycle, session.device)
        session = torch.where(replaced, fresh, session)
    counts = torch.clamp_max(draws["counts"], cfg.max_per_user_epoch)
    counts = torch.where(session, counts, torch.zeros_like(counts))
    new = StreamState(session=session, epoch=state.epoch + 1,
                      offered=state.offered + torch.sum(counts).to(torch.int32))
    return new, counts


def stream_step(cfg: StreamConfig, n_users: int, seed: int,
                state: StreamState) -> tuple[StreamState, Tensor]:
    """stream_step_from on the draws of (seed, state.epoch): epoch t's
    traffic is replayable from (seed, t) alone."""
    gen = torch.Generator(device=state.session.device)
    gen.manual_seed(fold_in(seed, state.epoch))
    return stream_step_from(cfg, n_users, step_draws(cfg, n_users, gen), state)


class RequestStream:
    """Deterministic per-user Poisson request generator for U user slots.
    device: None resolves to the card and raises without CUDA."""

    def __init__(self, cfg: StreamConfig, n_users: int, device=None):
        if cfg.max_per_user_epoch < 1:
            raise ValueError(
                f"max_per_user_epoch must be >= 1, got {cfg.max_per_user_epoch}")
        if not 0.0 < cfg.duty_cycle <= 1.0:
            raise ValueError(f"duty_cycle must be in (0, 1], got {cfg.duty_cycle}")
        self.cfg = cfg
        self.n_users = int(n_users)
        self.device = resolve_device(device)

    def generator(self, seed: int, counter: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(seed, counter))
        return gen

    def init_draws(self, gen: torch.Generator) -> Tensor:
        """The (U,) uniforms behind the initial sessions."""
        return torch.rand((self.n_users,), generator=gen, device=gen.device)

    def init_from(self, unit: Tensor) -> StreamState:
        active = unit < _f32(self.cfg.duty_cycle, unit.device)
        return StreamState(session=active, epoch=0,
                           offered=torch.zeros((), dtype=torch.int32, device=unit.device))

    def init(self, seed: int | torch.Generator) -> StreamState:
        """Initial sessions, drawn from ``seed`` (counter 0) or from a
        generator as it stands."""
        gen = seed if isinstance(seed, torch.Generator) else self.generator(seed, 0)
        return self.init_from(self.init_draws(gen))

    def step(self, seed: int, state: StreamState) -> tuple[StreamState, Tensor]:
        """Advance one epoch, drawing from (seed, state.epoch): (new state,
        per-user arrival counts (U,))."""
        return stream_step(self.cfg, self.n_users, seed, state)
