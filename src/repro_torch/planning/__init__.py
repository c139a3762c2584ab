"""Planning entry points: PlannerEngine.plan / replan and the fleet paths
plan_many / replan_many, with stack_envs, member and plan_state_template."""
from repro_torch.planning.engine import (  # noqa: F401
    PlannerEngine,
    PlanState,
    WarmStateShapeError,
    member,
    plan_state_template,
    stack_envs,
)
