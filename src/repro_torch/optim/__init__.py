"""AdamW with a cosine schedule, and top-k gradient compression with error
feedback, as plain functions on trees of tensors."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    adamw_init,
    adamw_update,
    adamw_update_,
    cosine_lr,
)
from repro_torch.optim.compression import (  # noqa: F401
    compress_topk,
    compressed_psum,
    decompress_topk,
    error_feedback_update,
)
