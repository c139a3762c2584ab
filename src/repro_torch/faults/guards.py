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

Bits 0-3 are planner-side (checked at replan, ``PLAN_MASK``). Bits 4-7 are
set by the online loop's telemetry and service guards, which this package
does not hold yet; their positions are kept so the word's layout is the
whole layout.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import SplitPlan, Tensor

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

