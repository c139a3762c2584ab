"""Durable serving: versioned snapshots of the online loop's full state,
a deterministic-replay flight recorder, and a crash supervisor that
resumes bit-exactly from the newest valid snapshot."""
from repro_torch.checkpoint.manager import SnapshotIntegrityError  # noqa: F401
from repro_torch.state.journal import (  # noqa: F401
    FlightRecorder,
    effective_trajectory,
    pack_word,
    read_journal,
    replay,
    unpack_word,
)
from repro_torch.state.snapshot import (  # noqa: F401
    SNAPSHOT_VERSION,
    SnapshotConfig,
    SnapshotStore,
    list_snapshots,
    load_snapshot,
    save_snapshot,
)
from repro_torch.state.supervisor import CrashSupervisor, SimulatedCrash  # noqa: F401
