"""Device resolution for the port's entry points.

Entry points take ``device=None`` and resolve it to the card. Without CUDA
they raise instead of carrying on quietly on the CPU; the CPU runs only when
the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> the current CUDA device. Raises when CUDA is asked for and
    absent. A bare ``"cuda"`` gets its index, so devices compare equal to the
    ``.device`` of tensors made on them."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card by default; "
                "pass device='cpu' to run its plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
