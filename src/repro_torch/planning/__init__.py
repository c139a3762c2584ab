"""Planning entry points: PlannerEngine.plan / replan and the fleet paths
plan_many / replan_many, with stack_envs, member and plan_state_template;
the engine's compiled programs (planning.programs) and compile_log."""
from repro_torch.planning.engine import (  # noqa: F401
    PlannerEngine,
    PlanState,
    WarmStateShapeError,
    compile_log,
    member,
    plan_state_template,
    stack_envs,
)
