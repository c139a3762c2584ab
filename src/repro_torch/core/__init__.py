"""ECC / Li-GD core: the paper's planner on PyTorch tensors."""
from repro_torch.core.types import (  # noqa: F401
    LOG2,
    ComputeConstants,
    EccWeights,
    GdConfig,
    GdVars,
    ModelProfile,
    NetworkEnv,
    ProfileShapeError,
    RadioConstants,
    SplitPlan,
    lam,
    make_weights,
)
from repro_torch.core.channel import (  # noqa: F401
    SINR_BACKENDS,
    downlink_rates,
    downlink_sinr,
    make_env,
    oma_rates,
    set_sinr_backend,
    uplink_rates,
    uplink_sinr,
    user_rates,
)
from repro_torch.core.utility import delay_energy, per_user_utility, utility  # noqa: F401
from repro_torch.core.li_gd import (  # noqa: F401
    GdResult,
    LoopResult,
    assemble_plan,
    cold_init,
    gd_loop,
    gd_solve,
    greedy_round_dn,
    greedy_round_up,
    project_simplex,
    project_simplex_floor,
    rho_estimate,
    round_beta,
    solve,
    to_physical,
)
from repro_torch.core import profiles  # noqa: F401
