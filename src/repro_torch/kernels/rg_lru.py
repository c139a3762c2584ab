"""The RG-LRU recurrence h_t = exp(log_a_t) * h_{t-1} + b_t and its
gradient: the wrappers around the CUDA kernels in csrc/rg_lru.cu and
csrc/rg_lru_bwd.cu, and their plain PyTorch twins.

For CUDA tensors a wrapper launches its kernel (counted in LAUNCHES) or
raises; for CPU tensors it computes its plain twin, which is also what the
kernel is held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

LAUNCHES = {"rg_lru": 0, "rg_lru_bwd": 0}
# The kernels' geometry lives in their sources: one-warp blocks of 32
# channels, one thread each with its state in registers; the operands reach
# it through a ring of time tiles in static shared memory, filled ahead
# (backwards in time for the gradient) by TMA where uses_tma allows it,
# else by cp.async.


def uses_tma(w: int, *ptrs: int) -> bool:
    """Whether the ring is filled by TMA: the tensor map's strides (W * 4
    bytes) and base addresses must be multiples of 16 bytes."""
    return w % 4 == 0 and all(p % 16 == 0 for p in ptrs)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(log_a, named: dict, h0):
    bsz, s, w = log_a.shape
    dev = log_a.device
    build.check("log_a", log_a, torch.float32, (bsz, s, w), dev)
    for name, t in named.items():
        build.check(name, t, torch.float32, (bsz, s, w), dev)
    if h0 is not None:
        build.check("h0", h0, torch.float32, (bsz, w), dev)
    return bsz, s, w, dev


def rg_lru(log_a, b, h0=None) -> torch.Tensor:
    """(B, S, W) float32 hidden states from log_a, b (B, S, W) and the
    optional initial state h0 (B, W) (zeros when None), all float32 and
    contiguous."""
    bsz, s, w, dev = _check(log_a, {"b": b}, h0)
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


def rg_lru_bwd(log_a, h, h0, dh):
    """The gradient of rg_lru: (dlog_a, db, dh0) from the forward's log_a
    and output h (B, S, W), its h0 (B, W) or None, and dh = dL/dh (B, S,
    W), all float32 and contiguous. dh0 is None when h0 is."""
    bsz, s, w, dev = _check(log_a, {"h": h, "dh": dh}, h0)
    if dev.type != "cuda":
        return rg_lru_bwd_plain(log_a, h, h0, dh)
    dlog_a, db = torch.empty_like(log_a), torch.empty_like(log_a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if log_a.numel() == 0:
        if dh0 is not None:
            dh0.zero_()
        return dlog_a, db, dh0
    tma = uses_tma(w, log_a.data_ptr(), h.data_ptr(), dh.data_ptr())
    rc = build.load("rg_lru_bwd").rg_lru_bwd(
        build.ptr(log_a), build.ptr(h), build.ptr(dh), build.ptr(h0), build.ptr(dlog_a),
        build.ptr(db), build.ptr(dh0), bsz, s, w, int(tma), dev.index, build.stream(dev))
    build.raise_on(rc, "rg_lru_bwd")
    LAUNCHES["rg_lru_bwd"] += 1
    return dlog_a, db, dh0


def rg_lru_bwd_plain(log_a, h, h0, dh):
    """Plain twin of rg_lru_bwd: the reverse recurrence lam_t = a_{t+1} *
    lam_{t+1} + dh_t stepped from S - 1 down to 0, db = lam, dlog_a_t =
    (lam_t * a_t) * h_{t-1} (h_{-1} = h0, or zeros), dh0 = a_0 * lam_0,
    each product and sum rounded separately, as the kernel rounds them."""
    a = torch.exp(log_a)
    lam = torch.zeros_like(log_a[:, 0])
    a_next = torch.zeros_like(lam)
    h_init = torch.zeros_like(lam) if h0 is None else h0
    dlog_a, db = torch.empty_like(log_a), torch.empty_like(log_a)
    for t in range(log_a.shape[1] - 1, -1, -1):
        lam = a_next * lam + dh[:, t]
        db[:, t] = lam
        dlog_a[:, t] = (lam * a[:, t]) * (h[:, t - 1] if t > 0 else h_init)
        a_next = a[:, t]
    return dlog_a, db, None if h0 is None else a_next * lam
