"""Planning entry points: PlannerEngine.plan / replan."""
from repro_torch.planning.engine import (  # noqa: F401
    PlannerEngine,
    PlanState,
    WarmStateShapeError,
)
