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
# The kernel's geometry lives in csrc/rg_lru.cu: one-warp blocks of 32
# channels, one thread each with h in a register; log_a and b reach it
# through a ring of time tiles in static shared memory, filled ahead by TMA
# where uses_tma allows it, else by cp.async.


def uses_tma(w: int, *ptrs: int) -> bool:
    """Whether the ring is filled by TMA: the tensor map's strides (W * 4
    bytes) and base addresses must be multiples of 16 bytes."""
    return w % 4 == 0 and all(p % 16 == 0 for p in ptrs)


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
    tma = uses_tma(w, log_a.data_ptr(), b.data_ptr())
    rc = build.load("rg_lru").rg_lru(build.ptr(log_a), build.ptr(b), build.ptr(h0),
                                     build.ptr(out), bsz, s, w, int(tma), dev.index,
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
