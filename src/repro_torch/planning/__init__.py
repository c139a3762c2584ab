"""Planning entry points: PlannerEngine.plan / replan and the fleet paths
plan_many / replan_many, with stack_envs and member."""
from repro_torch.planning.engine import (  # noqa: F401
    PlannerEngine,
    PlanState,
    WarmStateShapeError,
    member,
    stack_envs,
)
