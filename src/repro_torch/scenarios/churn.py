"""User arrival/departure churn with a fixed-size user pool.

The planner's shapes must not change between epochs, so Poisson churn is
slot replacement: departures free a slot that the next arrival immediately
reuses. Each epoch draws K ~ Poisson(rate * dt) replacement events
(approximated per user as an independent Bernoulli with the matched mean,
exact in the sparse regime rate*dt << U); a replaced user gets a fresh
position, waypoint, and decorrelated fading -- exactly what a new user
joining the cell looks like to the planner.

Draws come from a torch.Generator; the ``*_from`` cores take them as tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.scenarios import fading
from repro_torch.scenarios.mobility import MobilityState

Tensor = torch.Tensor


def _probability(n_users: int, rate_hz: float, dt_s: float) -> float:
    """The per-slot Bernoulli probability rounded to float32 and clipped to
    [0, 1], as a Python float (exactly a float32 value)."""
    p = np.float32(rate_hz * dt_s / max(n_users, 1))
    return float(np.clip(p, np.float32(0.0), np.float32(1.0)))


def replacement_probability(n_users: int, rate_hz: float, dt_s: float) -> Tensor:
    """The per-slot Bernoulli probability, clipped to [0, 1] in float32."""
    return torch.full((), _probability(n_users, rate_hz, dt_s), dtype=torch.float32)


def mask_from(unit: Tensor, n_users: int, rate_hz: float, dt_s: float) -> Tensor:
    """([B,] U) bool from unit uniforms: replaced where unit < p, p made by
    a fill on unit's device (no copy from the host: a CUDA graph may
    capture this)."""
    p = torch.full((), _probability(n_users, rate_hz, dt_s), dtype=torch.float32,
                   device=unit.device)
    return unit < p


def replacement_mask(gen: torch.Generator, n_users: int, rate_hz: float,
                     dt_s: float) -> Tensor:
    """(U,) bool: which user slots are replaced this epoch."""
    unit = torch.rand((n_users,), generator=gen, device=gen.device)
    return mask_from(unit, n_users, rate_hz, dt_s)


def churn_draws(gen: torch.Generator, pos_shape, h_shape) -> dict:
    """The draws behind apply_churn: unit uniforms for the new positions and
    waypoints, and the normal pairs of the new coefficients."""
    dev = gen.device
    return {"pos": torch.rand(pos_shape, generator=gen, device=dev),
            "waypoint": torch.rand(pos_shape, generator=gen, device=dev),
            "h_up": fading.normal_pair(gen, h_shape),
            "h_dn": fading.normal_pair(gen, h_shape)}


def apply_churn_from(draws: dict, mask: Tensor, mob: MobilityState, h_up: Tensor,
                     h_dn: Tensor, side_m: float) -> tuple[MobilityState, Tensor, Tensor]:
    """Replace the masked slots' position, waypoint and fading; others
    untouched. mask ([B,] U); h ([B,] U, N, M) complex."""
    m2, m3 = mask[..., None], mask[..., None, None]
    mob = MobilityState(pos=torch.where(m2, draws["pos"] * side_m, mob.pos),
                        waypoint=torch.where(m2, draws["waypoint"] * side_m, mob.waypoint))
    h_up = torch.where(m3, fading.coeffs_from(*draws["h_up"]), h_up)
    h_dn = torch.where(m3, fading.coeffs_from(*draws["h_dn"]), h_dn)
    return mob, h_up, h_dn


def apply_churn(gen: torch.Generator, mask: Tensor, mob: MobilityState, h_up: Tensor,
                h_dn: Tensor, side_m: float) -> tuple[MobilityState, Tensor, Tensor]:
    return apply_churn_from(churn_draws(gen, mob.pos.shape, h_up.shape), mask, mob,
                            h_up, h_dn, side_m)
