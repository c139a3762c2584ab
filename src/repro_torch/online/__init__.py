"""Closed-loop online serving: request streams, continuous batching,
measured-profile telemetry, and a QoS monitor that drives the planner: the
ECC planner operating on live traffic instead of static profiles."""
from repro_torch.online.streams import (  # noqa: F401
    RequestStream,
    StreamConfig,
    StreamState,
    stream_step,
)
from repro_torch.online.batcher import (  # noqa: F401
    BatchState,
    Completions,
    ContinuousBatcher,
    DecodeBatcher,
    EdgeBatcher,
    slot_update,
    slot_where,
)
from repro_torch.online.telemetry import (  # noqa: F401
    Observation,
    Telemetry,
    TelemetryState,
    measured_profile,
    telemetry_update,
)
from repro_torch.online.qos import (  # noqa: F401
    QosConfig,
    QosMonitor,
    QosReport,
    QosState,
    qos_update,
)
from repro_torch.online.loop import (  # noqa: F401
    EpochOut,
    OnlineLoop,
    ServiceConfig,
)
from repro_torch.faults.degrade import LadderConfig  # noqa: F401
from repro_torch.faults.injectors import FaultConfig  # noqa: F401
