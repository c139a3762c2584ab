"""Chaos engineering for the closed loop: seeded fault injection, device-side
health guards, and the graceful-degradation ladder.

Three layers:

* ``injectors`` -- deterministic fault processes (deep-fade link outages,
  AP blackouts, telemetry dropout/corruption, service-time spikes) drawn on
  the device from the epoch's counter-based generator. Fault rates are
  float32 device scalars (``FaultConfig.rates()``), so sweeping an outage
  rate is an operand swap; the persistent outage masks are a ``FaultState``
  threaded across epochs like every other loop state.
* ``guards`` -- device-side finiteness/feasibility checks over plans,
  measured profiles, observations and service times, packed into ONE int32
  health word per epoch. The planner's plan check rides the replan's s*
  read as ``(health << 16) | s``.
* ``degrade`` -- the host-side degradation ladder
  (reject-and-hold-last-good-plan -> telemetry quarantine -> baseline
  fallback -> cold replan with exponential backoff) plus the epoch
  watchdog generalizing ``runtime.ft`` to the serving path.
"""
from repro_torch.faults.degrade import (  # noqa: F401
    DegradeLadder,
    EpochWatchdog,
    LadderConfig,
    fallback_plan,
)
from repro_torch.faults.guards import (  # noqa: F401
    HEALTH_BITS,
    PLAN_MASK,
    PLAN_WORD_SHIFT,
    TELEMETRY_MASK,
    decode_health,
    observation_health,
    pack_health,
    plan_health,
    plan_word,
    service_health,
    split_plan_word,
    telemetry_health,
    tree_select,
)
from repro_torch.faults.injectors import (  # noqa: F401
    FaultConfig,
    FaultDraw,
    FaultRates,
    FaultState,
    apply_env_faults,
    corrupt_observation,
    fault_step,
    init_fault_state,
    spike_service,
)
