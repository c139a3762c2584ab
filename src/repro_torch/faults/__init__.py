"""Health guards of the closed loop: device-side finiteness and feasibility
checks packed into one int32 health word, so the host learns what it needs
from one scalar. The planner's plan check rides the replan's s* read as
``(health << 16) | s``.

The telemetry-side guards (telemetry_health, observation_health), the
fault injectors and the degradation ladder wait for the port of the
online loop.
"""
from repro_torch.faults.guards import (  # noqa: F401
    HEALTH_BITS,
    PLAN_MASK,
    PLAN_WORD_SHIFT,
    plan_health,
    plan_word,
    split_plan_word,
)
