from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    SnapshotIntegrityError,
    leaf_crc32,
    list_steps,
    load_checkpoint,
    save_checkpoint,
)
