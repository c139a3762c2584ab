"""Time-correlated NOMA-MEC scenarios: Gauss-Markov fading, random-waypoint
mobility, Poisson churn, and named deployment presets."""
from repro_torch.scenarios import churn, fading, mobility, presets  # noqa: F401
from repro_torch.scenarios.scenario import (  # noqa: F401
    Scenario,
    ScenarioConfig,
    ScenarioState,
)
