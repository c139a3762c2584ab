"""Flash attention (causal / local-window / bidirectional, GQA): the
wrapper around the CUDA kernel in csrc/flash_attention.cu, and its plain
PyTorch twin.

Layout, as the JAX package's kernel: q (B*KV*G, Sq, hd) with query head row
bh = (b*KV + kv)*G + g, k/v (B*KV, Sk, hd); the KV row of bh is bh // G.
Query and key positions are 0..Sq-1 and 0..Sk-1 (fresh sequences).

For CUDA tensors the wrapper launches the kernel (counted in LAUNCHES, and
by shape in SHAPES) or raises; for CPU tensors it computes flash_attention_plain, which is also
what the kernel is held against on the card.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build

LAUNCHES = {"flash_attention": 0}
# the same launches by shape: (query head rows, Sq, Sk, hd, group, causal,
# window, kv_len) -> count
SHAPES: Counter = Counter()

# -- Hopper block table (csrc/flash_attention.cu) -------------------------------
# bf16 (tensor cores): one thread block of two warpgroups per (query head
# row, WG_BLOCK_Q queries), each warpgroup 64 query rows; K/V tiles of
# WG_BLOCK_K keys stream through a WG_STAGES-deep TMA ring. Tiles are
# 128-byte swizzled rows of 64 bf16, so head dims under 64 are staged 64
# wide. float32 (FMA kernel): 16 x 16 threads per (query head row,
# F32_BLOCK_Q queries), F32_BLOCK_K keys at a time. Both under the 227 KB
# of dynamic shared memory a block may opt in to (smem_bytes).
WG_BLOCK_Q = 128
WG_BLOCK_K = 64
WG_STAGES = 2
F32_BLOCK_Q = 64
F32_BLOCK_K = 64
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)
NEG_INF = -1e30
# Tensor maps (the bf16 path's TMA descriptors) need 16-byte-aligned data.
TMA_ALIGN_BYTES = 16


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block.

    bf16: 1024 bytes of slack to align the base to the swizzle's 1024-byte
    atom, the Q tile, WG_STAGES stages of K and V tiles (64 columns wide at
    least), and 1 + WG_STAGES 8-byte mbarriers. float32: Q and K tiles with
    rows padded by one element, the V tile, the P tile (rows padded by one)
    and the three per-row vectors m, l, corr."""
    if dtype == torch.bfloat16:
        hdp = max(hd, 64)
        return 1024 + 2 * hdp * (WG_BLOCK_Q + 2 * WG_STAGES * WG_BLOCK_K) + 8 * (1 + WG_STAGES)
    return 4 * ((F32_BLOCK_Q + F32_BLOCK_K) * (hd + 1) + F32_BLOCK_K * hd) + 4 * (
        F32_BLOCK_Q * (F32_BLOCK_K + 1) + 3 * F32_BLOCK_Q)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()


def attention_mask(sq: int, sk: int, causal: bool, window: int, kv_len: int, device):
    """(Sq, Sk) bool, True where query q_pos may attend to key k_pos."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    return mask


def flash_attention(q, k, v, group: int, causal: bool = True, window: int = 0,
                    kv_len: int | None = None) -> torch.Tensor:
    """Softmax attention of each query head row over its KV row, (BH, Sq, hd)
    in q's dtype. q (BH, Sq, hd), k/v (BH // group, Sk, hd), all bf16 or all
    float32, contiguous; hd in HEAD_DIMS; keys at or past kv_len (default
    Sk) are masked. A query row with no unmasked key is undefined."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    kv_len = sk if kv_len is None else kv_len
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be one of {DTYPES}, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {hd}")
    if group < 1 or bh % group:
        raise ValueError(f"group={group} must divide the {bh} query head rows")
    if not 0 <= kv_len <= sk:
        raise ValueError(f"kv_len={kv_len} outside [0, {sk}]")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    build.check("q", q, q.dtype, (bh, sq, hd), dev)
    build.check("k", k, q.dtype, (bh // group, sk, hd), dev)
    build.check("v", v, q.dtype, (bh // group, sk, hd), dev)
    if dev.type != "cuda":
        return flash_attention_plain(q, k, v, group, causal, window, kv_len)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % TMA_ALIGN_BYTES:
                raise ValueError(f"{name} must start on a {TMA_ALIGN_BYTES}-byte boundary "
                                 "(a TMA tensor map's requirement)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = build.load("flash_attention").flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), bh, sq, sk, hd, group,
        int(causal), window, kv_len, int(q.dtype == torch.bfloat16), hd**-0.5,
        dev.index, build.stream(dev))
    build.raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    SHAPES[(bh, sq, sk, hd, group, bool(causal), window, kv_len)] += 1
    return out


def flash_attention_plain(q, k, v, group: int, causal: bool = True, window: int = 0,
                          kv_len: int | None = None) -> torch.Tensor:
    """Plain twin of flash_attention, rounding where the kernel rounds:
    float32 scores times hd^-0.5, masked to -1e30; p = exp(s - max) summed
    unrounded and rounded to v's dtype before the AV product; the sum over
    keys divided by max(l, 1e-30), cast to q's dtype. One pass over all
    keys, where the kernel carries a running max over key blocks."""
    bh, sq, hd = q.shape
    n_kv, sk = k.shape[0], k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    qg = q.float().view(n_kv, group, sq, hd)
    s = torch.matmul(qg, k.float()[:, None].transpose(-1, -2)) * hd**-0.5
    s = torch.where(attention_mask(sq, sk, causal, window, kv_len, q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float()[:, None])
    return (acc / l.clamp_min(1e-30)).to(q.dtype).view(bh, sq, hd)
