"""Measured-profile telemetry: live timings folded back into a ModelProfile.

The planner's static profile says what each layer *should* cost; serving
says what it *does* cost under real load (edge contention, radio fades the
channel model didn't price, thermal throttling on device). Telemetry closes
that gap without changing the planner at all: observed per-layer wall times
are converted back into the planner's native units (*effective FLOPs* at
the speed of whichever side executed the layer, and *effective bits* at the
priced NOMA rate for the transfer), EMA-smoothed into a TelemetryState
whose tensors are shaped exactly like the static profile's tables. Each
feedback epoch, ``profile()`` rebuilds a ModelProfile via
``ModelProfile.like`` (same shapes, dtypes and name), so the measured
profile is a plain operand swap for the planner.

Attribution (the one modeling choice): a single shared ``fl`` table cannot
express one-sided edge congestion (the planner divides the same fl[i] by
*both* sides' speeds, so uniformly inflated entries cancel out of the
split comparison). The telemetry therefore keeps ``fl`` congestion-
normalized (device layers: ``t_obs * c_device``; edge layers:
``t_obs * lam(r) * c_min_edge / kappa``) and captures congestion in the
one scalar that survives the division: ``kappa``, the edge slowdown
estimated from the suffix layers' observed-vs-intrinsic times. ``kappa``
is then folded into the measured ``m_down`` as effective extra downlink
bits, ``suf(s') * (kappa - 1) / (lam(r) c_min) * rate_dn``, which makes
the planner's t_dn(s') reproduce the *true* congested edge delay for
every candidate split s'. Under edge load the whole offload branch of the
utility curve rises and s* moves upward (keep more layers local); when
nothing is offloaded the suffix is unobservable and kappa relaxes toward 1
(optimistic re-probing, damped by the QoS cooldown). The split upload is
re-priced directly: ``w_meas[s] = t_up_obs * rate_up`` at the priced NOMA
rate, touched only at index s (a where-mask, so unvisited split points
keep their prior).

The update and the rebuild are tensor code on the device; nothing here
reads the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import ComputeConstants, ModelProfile, Tensor, lam


class TelemetryState(NamedTuple):
    """EMA-smoothed effective per-layer tables, shaped like the static
    profile (fl (F,), w (F+1,), m_down (F+1,)), plus the congestion
    estimate and the rate/compute references needed to express it."""

    fl: Tensor
    w: Tensor
    m_down: Tensor     # the *static* m_down prior; kappa is folded in by
                       # profile(), not accumulated here
    kappa: Tensor      # () f32 estimated edge slowdown (1 = uncongested)
    rate_dn: Tensor    # () f32 EMA mean downlink rate (bit/s)
    r_units: Tensor    # () f32 EMA mean edge compute units
    updates: Tensor    # () int32


class Observation(NamedTuple):
    """One feedback epoch's measurements, all device scalars/tensors.

    t_layer  (F,) observed wall seconds of each layer on the side that
             executed it (device for i < s, edge for i >= s)
    t_up     ()  observed split-upload seconds
    rate_up  ()  priced NOMA uplink rate (bit/s) the upload actually got
    rate_dn  ()  priced NOMA downlink rate (bit/s) for the result return
    r_units  ()  edge compute units serving the suffix (for lam(r))
    """

    t_layer: Tensor
    t_up: Tensor
    rate_up: Tensor
    rate_dn: Tensor
    r_units: Tensor


def telemetry_update(comp: ComputeConstants, decay: float, static_fl: Tensor,
                     state: TelemetryState, s: Tensor,
                     obs: Observation) -> TelemetryState:
    """Pure one-epoch update. ``static_fl`` is the static profile's
    per-layer FLOPs, the intrinsic-cost reference the edge-slowdown estimate
    is measured against; ``s`` the served split, a () int tensor."""
    a = decay
    f = state.fl.shape[0]
    dev = state.fl.device
    on_device = torch.arange(f, device=dev) < s
    edge_speed = lam(obs.r_units, comp) * comp.c_min_edge
    zero = torch.zeros((), dtype=state.fl.dtype, device=dev)

    # Edge slowdown: observed suffix seconds vs the intrinsic suffix cost at
    # the nominal edge speed. With nothing offloaded (s = F) the edge is
    # unobservable and the estimate relaxes toward 1: optimistic
    # re-probing, so a drained edge gets offered load again.
    suf_static = torch.sum(torch.where(on_device, zero, static_fl))
    t_edge = torch.sum(torch.where(on_device, zero, obs.t_layer))
    kappa_obs = torch.where(suf_static > 0.0,
                            t_edge * edge_speed / torch.clamp_min(suf_static, 1.0),
                            torch.ones_like(suf_static))
    kappa = torch.clamp_min(a * state.kappa + (1.0 - a) * kappa_obs, 1.0)

    # Congestion-normalized intrinsic cost: both sides' observations agree
    # on fl up to noise, so every layer updates.
    speed = torch.where(on_device, torch.full_like(kappa_obs, comp.c_device),
                        edge_speed / kappa_obs)
    fl_obs = obs.t_layer * speed
    fl = a * state.fl + (1.0 - a) * fl_obs

    # Re-price the upload only at the split actually exercised; the terminal
    # entry w[F] is structurally zero (no upload).
    idx = torch.arange(f + 1, device=dev)
    at_s = idx == s
    w_obs = obs.t_up * obs.rate_up
    w = torch.where(at_s & (idx < f), a * state.w + (1.0 - a) * w_obs, state.w)
    return TelemetryState(
        fl=fl.to(state.fl.dtype),
        w=w.to(state.w.dtype),
        m_down=state.m_down,
        kappa=kappa.to(torch.float32),
        rate_dn=(a * state.rate_dn + (1.0 - a) * obs.rate_dn).to(torch.float32),
        r_units=(a * state.r_units + (1.0 - a) * obs.r_units).to(torch.float32),
        updates=state.updates + 1,
    )


def measured_profile(comp: ComputeConstants, prof: ModelProfile,
                     state: TelemetryState) -> ModelProfile:
    """Pure rebuild of the measured profile from a TelemetryState.

    The congestion estimate is folded into m_down: candidate split s'
    suffers ``suf(s') * (kappa - 1) / (lam(r) c_min)`` extra edge seconds,
    expressed as downlink bits at the EMA rate so the planner's t_dn
    reproduces the congested delay curve exactly."""
    fl = state.fl
    prefix = torch.cat([fl.new_zeros(1), torch.cumsum(fl, 0)])
    # The total as the prefix's last entry, so that suffix[F] is exactly 0
    # (nothing offloaded, no congestion term), as in the reference.
    suffix = prefix[-1] - prefix
    edge_speed = lam(state.r_units, comp) * comp.c_min_edge
    extra_s = suffix * (state.kappa - 1.0) / torch.clamp_min(edge_speed, 1.0)
    m_down = state.m_down + extra_s * state.rate_dn
    return prof.like(state.fl, state.w, m_down)


class Telemetry:
    """Accumulates observations into a measured ModelProfile.

    Built from the *same* static profile the planner was constructed with
    (``validate_like`` enforces this once, at loop start); the static
    tables are both the prior and the EMA initial state."""

    def __init__(self, prof: ModelProfile, comp: ComputeConstants,
                 decay: float = 0.9):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.prof = prof
        self.comp = comp
        self.decay = float(decay)

    def init(self, prof: ModelProfile | None = None) -> TelemetryState:
        """Initial state from the planner's profile, on its device. If a
        (measured or otherwise substituted) ``prof`` is passed, it is
        validated against the static profile here: the loop-start shape
        check."""
        p = self.prof if prof is None else self.prof.validate_like(prof)
        dev = p.fl.device

        def f32(x: float) -> Tensor:
            return torch.full((), float(x), dtype=torch.float32, device=dev)

        return TelemetryState(fl=p.fl.clone(), w=p.w.clone(), m_down=p.m_down.clone(),
                              kappa=f32(1.0), rate_dn=f32(0.0),
                              r_units=f32(self.comp.r_min),
                              updates=torch.zeros((), dtype=torch.int32, device=dev))

    def update(self, state: TelemetryState, s: Tensor,
               obs: Observation) -> TelemetryState:
        """Fold one epoch's observation in."""
        return telemetry_update(self.comp, self.decay, self.prof.fl, state, s, obs)

    def profile(self, state: TelemetryState) -> ModelProfile:
        """The measured profile as a planner operand: same shapes, dtypes
        and name as the static profile (ModelProfile.like via
        ``measured_profile``). No host read."""
        return measured_profile(self.comp, self.prof, state)
