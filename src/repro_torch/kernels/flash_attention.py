"""Flash attention (causal / local-window / bidirectional, GQA): the
wrappers around the CUDA kernels in csrc/flash_attention.cu (forward) and
csrc/flash_attention_bwd.cu (its gradient), and their plain PyTorch twins.

Layout, as the JAX package's kernel: q (B*KV*G, Sq, hd) with query head row
bh = (b*KV + kv)*G + g, k/v (B*KV, Sk, hd); the KV row of bh is bh // G.
Query and key positions are 0..Sq-1 and 0..Sk-1 (fresh sequences).

For CUDA tensors a wrapper launches its kernel (counted in LAUNCHES, and
by shape in SHAPES / BWD_SHAPES) or raises; for CPU tensors it computes its
plain twin, which is also what the kernel is held against on the card. The
forward writes each query row's float32 log-sum-exp when asked (training);
the backward recomputes the probabilities from it. One backward call is
three CUDA launches (D = rowsum(dO * O), dK/dV, dQ) and counts as one.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build

LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
# the same launches by shape: (query head rows, Sq, Sk, hd, group, causal,
# window, kv_len) -> count; the forward's and the backward's
SHAPES: Counter = Counter()
BWD_SHAPES: Counter = Counter()

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


# -- Hopper block table of the backward (csrc/flash_attention_bwd.cu) -----------
# bf16 at BWD_WGMMA_HEAD_DIMS (wgmma): the dK/dV kernel holds BWD_BLOCK keys
# (K and V) a block and streams (query head, BWD_TILE-query tile) pairs of
# Q, dO and their LSE and D values through a BWD_STAGES-deep TMA ring; the
# dQ kernel holds BWD_BLOCK queries (Q and dO) and streams BWD_TILE-key
# tiles of K and V. Two consumer warpgroups a block, 64 rows each; tiles
# are 128-byte swizzled rows of 64 bf16 (head dims under 64 staged 64
# wide). bf16 at hd 256 and float32 keep the mma.sync / FMA kernels of 64
# rows (32 for float32 at hd 256) in padded shared memory.
BWD_BLOCK = 128
BWD_TILE = 64
BWD_STAGES = 3
BWD_WGMMA_HEAD_DIMS = (32, 64, 128)


def bwd_smem_bytes(hd: int, dtype: torch.dtype) -> tuple[int, int]:
    """Dynamic shared memory of one block of the backward's (dK/dV, dQ)
    kernels.

    wgmma path: 1024 bytes of slack (the swizzle's 1024-byte atom), the two
    held BWD_BLOCK-row tiles, BWD_STAGES stages of two BWD_TILE-row tiles,
    in dK/dV each stage's 64 float32 LSE and 64 D values, and an 8-byte
    mbarrier for the held tiles plus a full and an empty one a stage.
    mma.sync / FMA path (both kernels alike): K, V, Q and dO tiles with rows
    padded by 16 bytes, two float32 rows of the block, and in float32 each
    warp's 16-row P scratch (rows padded by one)."""
    if dtype == torch.bfloat16 and hd in BWD_WGMMA_HEAD_DIMS:
        hdp = max(hd, 64)
        dq = (1024 + 2 * 2 * BWD_BLOCK * hdp + BWD_STAGES * 2 * 2 * BWD_TILE * hdp
              + 8 * (1 + 2 * BWD_STAGES))
        return dq + BWD_STAGES * 2 * 4 * BWD_TILE, dq
    size = dtype.itemsize
    block = 32 if size == 4 and hd > 128 else 64
    scratch = 4 * (block // 16) * 16 * (block + 1) if size == 4 else 0
    n = 4 * size * block * (hd + 16 // size) + 2 * 4 * block + scratch
    return n, n


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SHAPES.clear()
    BWD_SHAPES.clear()


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


def _check_args(q, k, v, group: int, window: int, kv_len: int | None) -> int:
    """Validate a forward or backward call's q, k, v and options; returns
    kv_len (default Sk)."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
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
    build.check("q", q, q.dtype, (bh, sq, hd), q.device)
    build.check("k", k, q.dtype, (bh // group, sk, hd), q.device)
    build.check("v", v, q.dtype, (bh // group, sk, hd), q.device)
    return kv_len


def flash_attention(q, k, v, group: int, causal: bool = True, window: int = 0,
                    kv_len: int | None = None, return_lse: bool = False):
    """Softmax attention of each query head row over its KV row, (BH, Sq, hd)
    in q's dtype. q (BH, Sq, hd), k/v (BH // group, Sk, hd), all bf16 or all
    float32, contiguous; hd in HEAD_DIMS; keys at or past kv_len (default
    Sk) are masked. A query row with no unmasked key is undefined. With
    return_lse, returns (out, lse): lse (BH, Sq) float32 is each row's
    log-sum-exp of its scaled, masked scores (what the backward needs);
    without, the kernel writes none."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    kv_len = _check_args(q, k, v, group, window, kv_len)
    if dev.type != "cuda":
        return flash_attention_plain(q, k, v, group, causal, window, kv_len, return_lse)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % TMA_ALIGN_BYTES:
                raise ValueError(f"{name} must start on a {TMA_ALIGN_BYTES}-byte boundary "
                                 "(a TMA tensor map's requirement)")
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    rc = build.load("flash_attention").flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), build.ptr(lse), bh, sq, sk,
        hd, group, int(causal), window, kv_len, int(q.dtype == torch.bfloat16), hd**-0.5,
        dev.index, build.stream(dev))
    build.raise_on(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    SHAPES[(bh, sq, sk, hd, group, bool(causal), window, kv_len)] += 1
    return (out, lse) if return_lse else out


def flash_attention_plain(q, k, v, group: int, causal: bool = True, window: int = 0,
                          kv_len: int | None = None, return_lse: bool = False):
    """Plain twin of flash_attention, rounding where the kernel rounds:
    float32 scores times hd^-0.5, masked to -1e30; p = exp(s - max) summed
    unrounded and rounded to v's dtype before the AV product; the sum over
    keys divided by max(l, 1e-30), cast to q's dtype; lse = max + log(l).
    One pass over all keys, where the kernel carries a running max over key
    blocks."""
    bh, sq, hd = q.shape
    n_kv, sk = k.shape[0], k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    qg = q.float().view(n_kv, group, sq, hd)
    s = torch.matmul(qg, k.float()[:, None].transpose(-1, -2)) * hd**-0.5
    s = torch.where(attention_mask(sq, sk, causal, window, kv_len, q.device), s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float()[:, None])
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).view(bh, sq, hd)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).view(bh, sq)


def flash_attention_bwd(q, k, v, out, lse, dout, group: int, causal: bool = True,
                        window: int = 0, kv_len: int | None = None):
    """The gradient of flash_attention: (dq, dk, dv) in q's dtype for the
    cotangent dout of its output ``out``, from the forward's ``lse`` (BH, Sq)
    float32. Every tensor as in flash_attention, contiguous; on the card
    each starts on a 16-byte boundary. Keys at or past kv_len get zero
    gradient; a query row with no unmasked key is undefined."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    dev = q.device
    kv_len = _check_args(q, k, v, group, window, kv_len)
    build.check("out", out, q.dtype, (bh, sq, hd), dev)
    build.check("dout", dout, q.dtype, (bh, sq, hd), dev)
    build.check("lse", lse, torch.float32, (bh, sq), dev)
    if dev.type != "cuda":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, group, causal, window, kv_len)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("lse", lse)):
        if t.data_ptr() % TMA_ALIGN_BYTES:
            raise ValueError(f"{name} must start on a {TMA_ALIGN_BYTES}-byte boundary "
                             "(a TMA tensor map's requirement)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    # D (and on the wgmma path the LSE) in 64-row tiles: 2 x 64 a tile
    dvec = torch.empty((bh, 2 * BWD_TILE * -(-sq // BWD_TILE)), dtype=torch.float32, device=dev)
    rc = build.load("flash_attention_bwd").flash_attention_bwd(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), build.ptr(dout),
        build.ptr(lse), build.ptr(dvec), build.ptr(dq), build.ptr(dk), build.ptr(dv), bh, sq,
        sk, hd, group, int(causal), window, kv_len, int(q.dtype == torch.bfloat16), hd**-0.5,
        dev.index, build.stream(dev))
    build.raise_on(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    BWD_SHAPES[(bh, sq, sk, hd, group, bool(causal), window, kv_len)] += 1
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, out, lse, dout, group: int, causal: bool = True,
                              window: int = 0, kv_len: int | None = None):
    """Plain twin of flash_attention_bwd, in float32, rounding where the
    kernel rounds: P = exp(s * hd^-0.5 - lse) (0 where masked) from the
    float32 scores of the inputs; D = rowsum(dout * out); dP = dout v^T;
    dS = P (dP - D); P and dS are rounded to the inputs' dtype before the
    products dV = P^T dout, dK = dS^T q hd^-0.5 and dQ = dS k hd^-0.5 (a
    no-op in float32); the gradients are summed over the group's query
    heads and cast to q's dtype."""
    bh, sq, hd = q.shape
    n_kv, sk = k.shape[0], k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    dt, scale = q.dtype, hd**-0.5
    qg = q.float().view(n_kv, group, sq, hd)
    kf, vf = k.float()[:, None], v.float()[:, None]
    dog = dout.float().view(n_kv, group, sq, hd)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
    mask = attention_mask(sq, sk, causal, window, kv_len, q.device)
    p = torch.where(mask, torch.exp(s - lse.view(n_kv, group, sq, 1)), 0.0)
    d = (dog * out.float().view(n_kv, group, sq, hd)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dog, vf.transpose(-1, -2)) - d)
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(1)
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(1) * scale
    dq = torch.matmul(ds, kf) * scale
    return dq.to(dt).view(bh, sq, hd), dk.to(dt), dv.to(dt)


def flash_attention_bwd_scale(q, k, v, out, lse, dout, group: int, causal: bool = True,
                              window: int = 0, kv_len: int | None = None):
    """Per-element scales (dq, dk, dv), float32, that a check holds the
    gradients to: each gradient's sum of the magnitudes of its terms. dV:
    sum_i P |dO_i|; dK and dQ: sums of |dS| |q| (|k|) hd^-0.5, with |dS| taken
    as P (|dO| |v|^T + sum_d |dO| |O|), the magnitude of dP and D before
    their difference cancels."""
    bh, sq, hd = q.shape
    n_kv, sk = k.shape[0], k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    scale = hd**-0.5
    qg = q.float().view(n_kv, group, sq, hd)
    kf, vf = k.float()[:, None], v.float()[:, None]
    dog = dout.float().abs().view(n_kv, group, sq, hd)
    s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
    mask = attention_mask(sq, sk, causal, window, kv_len, q.device)
    p = torch.where(mask, torch.exp(s - lse.view(n_kv, group, sq, 1)), 0.0)
    d_abs = (dog * out.float().abs().view(n_kv, group, sq, hd)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dog, vf.abs().transpose(-1, -2)) + d_abs)
    s_dv = torch.matmul(p.transpose(-1, -2), dog).sum(1)
    s_dk = torch.matmul(ds.transpose(-1, -2), qg.abs()).sum(1) * scale
    s_dq = torch.matmul(ds, kf.abs()) * scale
    return s_dq.view(bh, sq, hd), s_dk, s_dv
