"""The RG-LRU recurrence h_t = exp(log_a_t) * h_{t-1} + b_t: the wrapper
around the CUDA kernel in csrc/rg_lru.cu, and its plain PyTorch twin.

For CUDA tensors the wrapper launches the kernel (counted in LAUNCHES) or
raises; for CPU tensors it computes rg_lru_plain, which is also what the
kernel is held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = {"rg_lru": 0}
# One thread per (b, w) channel, THREADS along w a block, the S loop
# unrolled by 8 (csrc/rg_lru.cu).
THREADS = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rg_lru(log_a, b, h0=None) -> torch.Tensor:
    """(B, S, W) float32 hidden states from log_a, b (B, S, W) and the
    optional initial state h0 (B, W) (zeros when None), all float32 and
    contiguous."""
    bsz, s, w = log_a.shape
    dev = log_a.device
    build.check("log_a", log_a, torch.float32, (bsz, s, w), dev)
    build.check("b", b, torch.float32, (bsz, s, w), dev)
    if h0 is not None:
        build.check("h0", h0, torch.float32, (bsz, w), dev)
    if dev.type != "cuda":
        return rg_lru_plain(log_a, b, h0)
    out = torch.empty_like(log_a)
    if out.numel() == 0:
        return out
    rc = build.load("rg_lru").rg_lru(build.ptr(log_a), build.ptr(b), build.ptr(h0),
                                     build.ptr(out), bsz, s, w, dev.index,
                                     build.stream(dev))
    build.raise_on(rc, "rg_lru")
    LAUNCHES["rg_lru"] += 1
    return out


def rg_lru_plain(log_a, b, h0=None) -> torch.Tensor:
    """Plain twin of rg_lru: the recurrence stepped over S, the product and
    the sum rounded separately, as the kernel rounds them."""
    a = torch.exp(log_a)
    h = torch.zeros_like(log_a[:, 0]) if h0 is None else h0
    out = torch.empty_like(log_a)
    for t in range(log_a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
