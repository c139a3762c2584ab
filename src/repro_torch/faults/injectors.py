"""Seeded, deterministic fault processes for the closed serving loop.

Every fault is drawn on the device from the epoch's counter-based
generator (the same (seed, epoch) scheme the scenario uses), so an episode
is exactly reproducible from its seed, and every per-epoch quantity is a
device tensor: injection reads nothing back to the host.

``FaultConfig`` is the host-side description; ``FaultConfig.rates()``
lowers it to ``FaultRates``, a NamedTuple of float32 device scalars that
enter the epoch as plain operands, so sweeping an outage rate swaps the
operand and nothing else.

Link outages and AP blackouts are persistent Gilbert-Elliott-style Markov
processes, not per-epoch coin flips: a user in a deep fade stays faded for
``link_mean_epochs`` on average, which is what makes holding the last good
plan (rather than replanning into the fade every epoch) a meaningful
strategy. The outage masks live in ``FaultState``, threaded across epochs
like every other loop state. ``link_outage_rate`` / ``ap_outage_rate`` are
the *long-run fraction of time* spent in outage, from which the per-epoch
onset probability is derived.

``fault_step`` splits into its draws (``fault_draws``: seven uniform
tensors, one per Bernoulli process, in the reference's key order) and a
deterministic core (``fault_step_from``); a Bernoulli(p) is ``uniform < p``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple

import torch

from repro_torch.core.types import NetworkEnv, Tensor
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # repro_torch.online imports the loop, which imports this
    # package back: annotation-only here keeps the import acyclic
    from repro_torch.online.telemetry import Observation

# The uniforms behind fault_step, in the order of the reference's key split.
DRAW_KEYS = ("link_fail", "link_recover", "ap_fail", "ap_recover", "tel_drop",
             "tel_spike", "svc_spike")


class FaultRates(NamedTuple):
    """Per-epoch fault probabilities/scales as float32 device scalars: the
    epoch's fault operand (same shapes for every config)."""

    link_fail: Tensor        # () P(healthy link enters a deep fade)
    link_recover: Tensor     # () P(faded link recovers)
    fade_depth: Tensor       # () gain multiplier inside a fade (<< 1)
    ap_fail: Tensor          # () P(healthy AP blacks out)
    ap_recover: Tensor       # () P(blacked-out AP recovers)
    tel_drop: Tensor         # () P(this epoch's telemetry sample is lost)
    tel_spike: Tensor        # () P(this epoch's telemetry sample is spiked)
    tel_spike_scale: Tensor  # () multiplier applied to a spiked sample
    svc_spike: Tensor        # () per-user P(service-time spike)
    svc_spike_scale: Tensor  # () multiplier applied to a spiked service


class FaultState(NamedTuple):
    """Persistent outage masks, threaded across epochs."""

    link_down: Tensor   # (U,) bool: user is in a deep fade
    ap_down: Tensor     # (N,) bool: AP is blacked out


class FaultDraw(NamedTuple):
    """One epoch's realized faults (device tensors)."""

    link_down: Tensor   # (U,) bool
    ap_down: Tensor     # (N,) bool
    tel_drop: Tensor    # () bool
    tel_spike: Tensor   # () bool
    svc_mult: Tensor    # (U,) f32 service-time multiplier (1.0 = clean)


def _onset(stationary: float, mean_epochs: float) -> float:
    """Markov onset probability giving the requested stationary outage
    fraction at the given mean outage duration."""
    pi = min(max(float(stationary), 0.0), 0.999)
    recover = 1.0 / max(float(mean_epochs), 1.0)
    return min(pi * recover / max(1.0 - pi, 1e-6), 1.0)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Host-side fault mix. All rates default to zero: a zero config is an
    exact identity on the loop (uniform < 0 never fires, multipliers stay
    1.0), so hardened and unhardened loops share one epoch."""

    link_outage_rate: float = 0.0       # long-run fraction of users in fade
    link_mean_epochs: float = 8.0       # mean fade duration
    fade_depth: float = 1e-6            # gain multiplier inside a fade
    ap_outage_rate: float = 0.0         # long-run fraction of APs down
    ap_mean_epochs: float = 20.0
    telemetry_drop_rate: float = 0.0    # P(sample lost -> NaN) per epoch
    telemetry_spike_rate: float = 0.0   # P(sample spiked) per epoch
    telemetry_spike_scale: float = 50.0
    service_spike_rate: float = 0.0     # per-user P(transient slow service)
    service_spike_scale: float = 10.0

    def rates(self, device=None) -> FaultRates:
        """Lower to the epoch's float32-scalar operand tuple on ``device``
        (None: the card)."""
        dev = resolve_device(device)

        def f32(x: float) -> Tensor:
            return torch.full((), float(x), dtype=torch.float32, device=dev)

        return FaultRates(
            link_fail=f32(_onset(self.link_outage_rate, self.link_mean_epochs)),
            link_recover=f32(1.0 / max(self.link_mean_epochs, 1.0)),
            fade_depth=f32(self.fade_depth),
            ap_fail=f32(_onset(self.ap_outage_rate, self.ap_mean_epochs)),
            ap_recover=f32(1.0 / max(self.ap_mean_epochs, 1.0)),
            tel_drop=f32(self.telemetry_drop_rate),
            tel_spike=f32(self.telemetry_spike_rate),
            tel_spike_scale=f32(self.telemetry_spike_scale),
            svc_spike=f32(self.service_spike_rate),
            svc_spike_scale=f32(self.service_spike_scale),
        )


def init_fault_state(n_users: int, n_aps: int, device=None) -> FaultState:
    dev = resolve_device(device)
    return FaultState(link_down=torch.zeros((int(n_users),), dtype=torch.bool, device=dev),
                      ap_down=torch.zeros((int(n_aps),), dtype=torch.bool, device=dev))


def fault_draws(gen: torch.Generator, n_users: int, n_aps: int) -> dict:
    """The epoch's uniforms, one tensor per Bernoulli process (DRAW_KEYS)."""
    shapes = {"link_fail": (n_users,), "link_recover": (n_users,), "ap_fail": (n_aps,),
              "ap_recover": (n_aps,), "tel_drop": (), "tel_spike": (),
              "svc_spike": (n_users,)}
    return {k: torch.rand(shapes[k], generator=gen, device=gen.device) for k in DRAW_KEYS}


def fault_step_from(rates: FaultRates, draws: dict,
                    state: FaultState) -> tuple[FaultState, FaultDraw]:
    """Advance the Markov outage masks one epoch and realize the epoch's
    transient faults from its uniforms. Pure; no host read."""
    link_down = torch.where(state.link_down, ~(draws["link_recover"] < rates.link_recover),
                            draws["link_fail"] < rates.link_fail)
    ap_down = torch.where(state.ap_down, ~(draws["ap_recover"] < rates.ap_recover),
                          draws["ap_fail"] < rates.ap_fail)
    svc_mult = torch.where(draws["svc_spike"] < rates.svc_spike, rates.svc_spike_scale,
                           torch.ones_like(rates.svc_spike_scale))
    new = FaultState(link_down=link_down, ap_down=ap_down)
    draw = FaultDraw(link_down=link_down, ap_down=ap_down,
                     tel_drop=draws["tel_drop"] < rates.tel_drop,
                     tel_spike=draws["tel_spike"] < rates.tel_spike,
                     svc_mult=svc_mult)
    return new, draw


def fault_step(rates: FaultRates, gen: torch.Generator,
               state: FaultState) -> tuple[FaultState, FaultDraw]:
    """fault_step_from on fresh draws from ``gen``."""
    draws = fault_draws(gen, state.link_down.shape[0], state.ap_down.shape[0])
    return fault_step_from(rates, draws, state)


def apply_env_faults(env: NetworkEnv, draw: FaultDraw, rates: FaultRates) -> NetworkEnv:
    """Mask the channel gains: faded users' gains scale by ``fade_depth``
    in both directions, blacked-out APs' gains go to exactly zero for the
    whole cell. Downstream rate floors (channel.user_rates and the loop's
    service model clamp rates at 1e-9) keep the math finite: a blackout
    produces astronomically bad but *finite* plans; the NaN channel is
    telemetry corruption. A zero draw returns gains scaled by 1.0."""
    one = torch.ones_like(rates.fade_depth)
    fade_u = torch.where(draw.link_down, rates.fade_depth, one)            # (U,)
    ap_up = torch.where(draw.ap_down, torch.zeros_like(one), one)          # (N,)
    g_up = env.g_up * fade_u[:, None, None] * ap_up[None, :, None]
    g_dn = env.g_dn * ap_up[:, None, None] * fade_u[None, :, None]
    return dataclasses.replace(env, g_up=g_up.to(env.g_up.dtype),
                               g_dn=g_dn.to(env.g_dn.dtype))


def corrupt_observation(obs: Observation, draw: FaultDraw,
                        rates: FaultRates) -> Observation:
    """Telemetry faults: a dropped sample becomes NaN (missing data that an
    unguarded EMA propagates forever: the silent-corruption channel), a
    spiked sample is scaled by ``tel_spike_scale`` (finite corruption that
    drives the kappa estimate off the rails)."""
    def hit(x: Tensor) -> Tensor:
        spiked = torch.where(draw.tel_spike, x * rates.tel_spike_scale, x)
        return torch.where(draw.tel_drop, torch.full_like(spiked, float("nan")), spiked)

    return obs._replace(t_layer=hit(obs.t_layer), t_up=hit(obs.t_up))


def spike_service(service: Tensor, draw: FaultDraw) -> Tensor:
    """Transient service-time spikes (a wedged edge worker, a GC pause):
    per-user multiplicative, memoryless."""
    return service * draw.svc_mult
