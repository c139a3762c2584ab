"""Device-side health guards: finiteness/feasibility checks packed into one
word.

Every check is a tensor operation on the device and yields an int32 bit;
the bits OR into a single *health word*. The planner-side plan check rides
the replan's s* read as ``(health << PLAN_WORD_SHIFT) | s`` (``plan_word`` /
``split_plan_word``), so a guarded replan still reads exactly one scalar.
Nothing here reads the host; the unpacking (``split_plan_word``) works on a
Python int.

Bit layout (LSB first; 0 = healthy):

  0 plan_utility   plan utility or per-layer utility non-finite
  1 plan_power     power vector non-finite or outside [0, p_max]
  2 plan_alloc     edge compute allocation non-finite or outside [0, r_max]
  3 plan_subch     subchannel index outside [0, M)
  4 profile        measured-profile tables (fl/w/m_down) non-finite
  5 kappa          congestion estimate non-finite or past ``kappa_max``
  6 telemetry      this epoch's observation non-finite
  7 service        this epoch's modeled service times non-finite

Bits 0-3 are planner-side (checked at replan, ``PLAN_MASK``); bits 4-6 are
the telemetry-quarantine trigger (``TELEMETRY_MASK``); bit 7 is
informational (service corruption surfaces in shedding/QoS).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core.types import SplitPlan, Tensor

if TYPE_CHECKING:  # repro_torch.online imports the loop, which imports this
    # package back: annotation-only here keeps the import acyclic
    from repro_torch.online.telemetry import Observation, TelemetryState

HEALTH_BITS: dict[str, int] = {
    "plan_utility": 0,
    "plan_power": 1,
    "plan_alloc": 2,
    "plan_subch": 3,
    "profile": 4,
    "kappa": 5,
    "telemetry": 6,
    "service": 7,
}

PLAN_MASK = 0b1111
TELEMETRY_MASK = (1 << HEALTH_BITS["profile"]) | (1 << HEALTH_BITS["kappa"]) \
    | (1 << HEALTH_BITS["telemetry"])

# The planner's packed word: health in the high bits, s* in the low 16.
PLAN_WORD_SHIFT = 16


def _bit(unhealthy: Tensor, name: str) -> Tensor:
    return unhealthy.to(torch.int32) << HEALTH_BITS[name]


def _all_finite(*xs: Tensor) -> Tensor:
    ok = torch.ones((), dtype=torch.bool, device=xs[0].device)
    for x in xs:
        ok = ok & torch.all(torch.isfinite(x))
    return ok


def plan_health(plan: SplitPlan, *, n_sub: int, p_up_max: float,
                p_dn_max: float, r_max: float, slack: float = 1.05) -> Tensor:
    """() int32 over bits 0-3. ``slack`` absorbs rounding noise at the box
    boundaries: the guard exists to catch corruption (NaN/Inf, wildly
    infeasible values), not to re-check the solver's projection."""
    bad_util = ~_all_finite(plan.utility, plan.per_layer_utility)
    ok_pow = (_all_finite(plan.p_up, plan.p_dn)
              & torch.all(plan.p_up >= 0.0)
              & torch.all(plan.p_up <= p_up_max * slack)
              & torch.all(plan.p_dn >= 0.0)
              & torch.all(plan.p_dn <= p_dn_max * slack))
    ok_alloc = (_all_finite(plan.r) & torch.all(plan.r >= 0.0)
                & torch.all(plan.r <= r_max * slack))
    ok_sub = (torch.all((plan.sub_up >= 0) & (plan.sub_up < n_sub))
              & torch.all((plan.sub_dn >= 0) & (plan.sub_dn < n_sub)))
    return (_bit(bad_util, "plan_utility") | _bit(~ok_pow, "plan_power")
            | _bit(~ok_alloc, "plan_alloc") | _bit(~ok_sub, "plan_subch"))


def plan_word(plan: SplitPlan, *, n_sub: int, p_up_max: float,
              p_dn_max: float, r_max: float) -> Tensor:
    """() int32 ``(plan_health << PLAN_WORD_SHIFT) | s``: the guarded
    replan's one host read carries both the re-cut decision and the plan's
    health. s is clamped into the low half-word; a non-finite or negative
    s maps to 0 with the utility bit necessarily set alongside it."""
    h = plan_health(plan, n_sub=n_sub, p_up_max=p_up_max, p_dn_max=p_dn_max,
                    r_max=r_max)
    s = torch.clamp(plan.s.to(torch.int32), 0, (1 << PLAN_WORD_SHIFT) - 1)
    return (h << PLAN_WORD_SHIFT) | s


def split_plan_word(word: int) -> tuple[int, int]:
    """Host-side unpack of ``plan_word`` -> (health, s)."""
    w = int(word)
    return w >> PLAN_WORD_SHIFT, w & ((1 << PLAN_WORD_SHIFT) - 1)



def telemetry_health(state: TelemetryState, kappa_max: float) -> Tensor:
    """() int32 over bits 4-5: is the measured profile still a sane planner
    operand? A kappa past ``kappa_max`` is finite but no longer a credible
    congestion estimate (a spiked sample landed): quarantine territory."""
    bad_prof = ~_all_finite(state.fl, state.w, state.m_down, state.rate_dn,
                            state.r_units)
    bad_kappa = ~(torch.isfinite(state.kappa) & (state.kappa <= kappa_max))
    return _bit(bad_prof, "profile") | _bit(bad_kappa, "kappa")


def observation_health(obs: Observation) -> Tensor:
    """() int32, bit 6: this epoch's telemetry sample arrived intact."""
    bad = ~_all_finite(obs.t_layer, obs.t_up, obs.rate_up, obs.rate_dn,
                       obs.r_units)
    return _bit(bad, "telemetry")


def service_health(service: Tensor) -> Tensor:
    """() int32, bit 7: modeled service times are finite."""
    return _bit(~_all_finite(service), "service")


def pack_health(*words: Tensor) -> Tensor:
    """OR component words into the epoch's single health scalar."""
    out = torch.zeros((), dtype=torch.int32, device=words[0].device)
    for w in words:
        out = out | w
    return out


def decode_health(word: int) -> dict[str, bool]:
    """Host-side: name -> bit set? (metrics and debugging; takes a Python
    int, never a device tensor)."""
    w = int(word)
    return {name: bool(w & (1 << bit)) for name, bit in HEALTH_BITS.items()}


def tree_select(keep_new: Tensor, new, old):
    """Per-leaf where over matching named tuples of tensors: the device-side
    quarantine gate (corrupt observation -> hold the previous telemetry
    state)."""
    return type(new)(*(torch.where(keep_new, a, b) for a, b in zip(new, old)))
