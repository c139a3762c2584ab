"""Serving runtime: ECC split-serve."""
from repro_torch.runtime.serve import (  # noqa: F401
    SplitPrograms,
    make_split_serve,
    planned_transfer_seconds,
    transfer_seconds,
)
