"""Serving runtime (ECC split-serve and the online split server) and the
training step."""
from repro_torch.runtime.serve import (  # noqa: F401
    OnlineSplitServer,
    SplitPrograms,
    make_split_serve,
    planned_transfer_seconds,
    transfer_seconds,
)
from repro_torch.runtime.train import (  # noqa: F401
    TrainState,
    init_state,
    loss_and_grads,
    loss_fn,
    loss_fn_chunked,
    make_train_step,
)
