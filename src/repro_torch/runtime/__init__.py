"""Serving runtime: ECC split-serve and the online split server."""
from repro_torch.runtime.serve import (  # noqa: F401
    OnlineSplitServer,
    SplitPrograms,
    make_split_serve,
    planned_transfer_seconds,
    transfer_seconds,
)
