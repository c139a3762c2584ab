"""The NOMA pairwise-interference kernels: wrappers, plain twins, composition.

The two terms of the SINR denominator of paper eqs. (5)/(8) run through
different kernels (the CUDA sources are in csrc/noma_rates.cu):

* the INTER-cell term factors through per-AP (N, M) tables,

    uplink:   inter[u,m] = A[ap[u], m],
              A[n,m]     = sum_v [ap[v] != n] * w_power[v,m] * g_up[v,n,m]
    downlink: inter[u,m] = sum_n [ap[u] != n] * g_dn[n,u,m] * B[n,m],
              B[n,m]     = sum_v [ap[v] == n] * w_power[v,m]

  noma_per_ap builds A (and the downlink backward table D); noma_ap_contract
  consumes B (and the uplink backward table C). The gain-free tables B and C
  are plain segment sums, and the row selections A[ap] / D[ap] are takes.

* the INTRA-cell SIC term is a per-pair comparison,

    intra[u,m] = sum_v same[u,v] * cmp(own_v[v,m], own_u[u,m]) * w_intra[v,m]

  taken by noma_cell_intra over a CSR list of (receiver block, streamed
  block) tiles: all pairs when no CellLayout is given, the same-cell
  block-diagonal tiles with one.

Every wrapper checks device, dtype, shape and contiguity. For CUDA tensors
it launches its kernel (counted in LAUNCHES) or raises; for CPU tensors it
computes its plain PyTorch twin, the function of the same name with the
suffix ``_plain``, which is also what the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# Launches of each kernel since the last reset_launches(): one count per
# kernel launch, and only there.
LAUNCHES = {"noma_cell_intra": 0, "noma_per_ap": 0, "noma_ap_contract": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- Hopper block table ------------------------------------------------------
# One thread block is LANES (along m, one warp, coalesced row-major loads) x
# WARPS threads. The intra kernel's receiver block holds up to
# WARPS * MAX_ROWS_PER_THREAD rows, held in registers (ROWS floats of own
# gain, ROWS ints of AP id and ROWS accumulators a thread, well under the
# 255-register limit). Its streamed block is staged in dynamic shared memory,
# intra_smem_bytes(block_s), kept under the 48 KiB a block gets without
# opting in to more.
LANES = 32
WARPS = 8
MAX_ROWS_PER_THREAD = 8
MAX_BLOCK_ROWS = WARPS * MAX_ROWS_PER_THREAD
SMEM_LIMIT_BYTES = 48 * 1024
# Default (receiver, streamed) block rows: 16 receivers a block gives
# 2 rows a thread and ~630 thread blocks at U=1250, M=250.
BLOCK_U = 16
BLOCK_V = 16


def intra_smem_bytes(block_s: int) -> int:
    """Dynamic shared memory of one intra thread block: own_s and w_s tiles
    of (block_s, LANES) floats plus block_s int32 AP ids."""
    return block_s * (2 * LANES * 4 + 4)


def _rows_per_thread(block_r: int) -> int:
    need = -(-block_r // WARPS)
    return next(r for r in (1, 2, 4, 8) if r >= need)


def dense_tile_count(n_r: int, n_s: int, block_r: int = BLOCK_U,
                     block_s: int = BLOCK_V) -> int:
    """Tile count of the dense (no-CellLayout) intra schedule: every
    (r-block, s-block) pair, with the blocks clamped as the kernels clamp."""
    br, bs = min(block_r, n_r), min(block_s, n_s)
    return -(-n_r // br) * -(-n_s // bs)


@functools.lru_cache(maxsize=64)
def dense_csr(n_blocks_r: int, n_blocks_s: int, device: torch.device):
    """(row_ptr, col) int32 of the dense schedule: every receiver block
    streams every block, in order. Shape-derived, cached per shape."""
    row_ptr = torch.arange(n_blocks_r + 1, dtype=torch.int32, device=device)
    col = torch.arange(n_blocks_s, dtype=torch.int32, device=device)
    return row_ptr * n_blocks_s, col.repeat(n_blocks_r)


# -- argument checks -----------------------------------------------------------
def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


# -- kernel 1: intra (SIC) -----------------------------------------------------
def noma_cell_intra(own_r, own_s, w_s, ap_r, ap_s, row_ptr, col,
                    block_r: int, block_s: int,
                    descending: bool = True) -> torch.Tensor:
    """SIC intra reduction over a CSR tile list, (R, M):

      out[r,m] = sum_s [ap_r[r] == ap_s[s]] * cmp(own_s, own_r) * w_s[s,m]

    own_r (R, M), own_s/w_s (S, M) float32; ap_r (R,), ap_s (S,) int32;
    row_ptr (ceil(R/block_r)+1,) and col (T,) int32: receiver block b
    streams blocks col[row_ptr[b]:row_ptr[b+1]]. cmp is '<' when
    descending (uplink SIC order), '>' otherwise. The tile set must cover
    every block pair holding a same-cell pair exactly once."""
    r, m = own_r.shape
    s = own_s.shape[0]
    dev = own_r.device
    n_rb = -(-r // block_r) if r else 0
    _check("own_r", own_r, torch.float32, (r, m), dev)
    _check("own_s", own_s, torch.float32, (s, m), dev)
    _check("w_s", w_s, torch.float32, (s, m), dev)
    _check("ap_r", ap_r, torch.int32, (r,), dev)
    _check("ap_s", ap_s, torch.int32, (s,), dev)
    _check("row_ptr", row_ptr, torch.int32, (n_rb + 1,), dev)
    _check("col", col, torch.int32, (col.shape[0],), dev)
    if not 1 <= block_r <= MAX_BLOCK_ROWS:
        raise ValueError(f"block_r must be in [1, {MAX_BLOCK_ROWS}], got {block_r}")
    if block_s < 1 or intra_smem_bytes(block_s) > SMEM_LIMIT_BYTES:
        raise ValueError(f"block_s={block_s} needs {intra_smem_bytes(block_s)} "
                         f"bytes of shared memory, over {SMEM_LIMIT_BYTES}")
    if dev.type != "cuda":
        return noma_cell_intra_plain(own_r, own_s, w_s, ap_r, ap_s, row_ptr,
                                     col, block_r, block_s, descending)
    out = torch.empty((r, m), dtype=torch.float32, device=dev)
    if r == 0 or m == 0:
        return out
    rc = build.load().noma_cell_intra(
        _ptr(own_r), _ptr(own_s), _ptr(w_s), _ptr(ap_r), _ptr(ap_s),
        _ptr(row_ptr), _ptr(col), _ptr(out), r, s, m, block_r, block_s,
        _rows_per_thread(block_r), int(descending), dev.index, _stream(dev))
    _raise_on(rc, "noma_cell_intra")
    LAUNCHES["noma_cell_intra"] += 1
    return out


def noma_cell_intra_plain(own_r, own_s, w_s, ap_r, ap_s, row_ptr, col,
                          block_r: int, block_s: int,
                          descending: bool = True) -> torch.Tensor:
    """Plain twin of noma_cell_intra: the same tile-restricted sum through a
    (R, S, M) select. No host sync, so it runs inside CUDA graphs."""
    r, s = own_r.shape[0], own_s.shape[0]
    dev = own_r.device
    n_rb, n_sb = row_ptr.shape[0] - 1, -(-s // block_s)
    t_idx = torch.arange(col.shape[0], device=dev)
    t_row = torch.searchsorted(row_ptr[1:], t_idx, right=True)
    tiles = torch.zeros(n_rb * n_sb, dtype=torch.bool, device=dev)
    tiles = tiles.index_fill_(0, t_row * n_sb + col.long(), True).view(n_rb, n_sb)
    r_blk = torch.arange(r, device=dev) // block_r
    s_blk = torch.arange(s, device=dev) // block_s
    pair = (ap_r[:, None] == ap_s[None, :]) & tiles[r_blk][:, s_blk]
    if descending:
        cmp = own_s[None, :, :] < own_r[:, None, :]
    else:
        cmp = own_s[None, :, :] > own_r[:, None, :]
    keep = cmp & pair[:, :, None]
    return torch.where(keep, w_s[None, :, :], 0.0).sum(1)


# -- kernel 2: per-AP table ------------------------------------------------------
def _gain_dims(g_raw, uplink: bool, w: int):
    n = g_raw.shape[1] if uplink else g_raw.shape[0]
    m = g_raw.shape[2]
    return n, m, ((w, n, m) if uplink else (n, w, m))


def noma_per_ap(ap, wgt, g_raw, uplink: bool = True) -> torch.Tensor:
    """Other-cell per-AP reduction, (N, M):

      out[n,m] = sum_w [ap[w] != n] * wgt[w,m] * g[w,n,m]   (uplink layout)
      out[n,m] = sum_w [ap[w] != n] * wgt[w,m] * g[n,w,m]   (downlink layout)
    """
    w = ap.shape[0]
    n, m, g_shape = _gain_dims(g_raw, uplink, w)
    dev = ap.device
    _check("ap", ap, torch.int32, (w,), dev)
    _check("wgt", wgt, torch.float32, (w, m), dev)
    _check("g_raw", g_raw, torch.float32, g_shape, dev)
    if dev.type != "cuda":
        return noma_per_ap_plain(ap, wgt, g_raw, uplink)
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if n == 0 or m == 0:
        return out
    rc = build.load().noma_per_ap(_ptr(ap), _ptr(wgt), _ptr(g_raw), _ptr(out),
                                  w, n, m, int(uplink), dev.index, _stream(dev))
    _raise_on(rc, "noma_per_ap")
    LAUNCHES["noma_per_ap"] += 1
    return out


def _other_cell(ap, n_aps: int):
    """(W, N) bool: [ap[w] != n]."""
    return ap[:, None] != torch.arange(n_aps, device=ap.device, dtype=ap.dtype)


def noma_per_ap_plain(ap, wgt, g_raw, uplink: bool = True) -> torch.Tensor:
    n = g_raw.shape[1] if uplink else g_raw.shape[0]
    other = _other_cell(ap, n)
    if uplink:
        return torch.where(other[:, :, None], wgt[:, None, :] * g_raw, 0.0).sum(0)
    return torch.where(other.T[:, :, None], g_raw * wgt[None, :, :], 0.0).sum(1)


# -- kernel 3: per-AP contraction ------------------------------------------------
def noma_ap_contract(ap, nm_table, g_raw, uplink: bool = True) -> torch.Tensor:
    """Other-cell contraction of a per-AP table against the raw gain, (W, M):

      out[w,m] = sum_n [ap[w] != n] * g[w,n,m] * nm[n,m]   (uplink layout)
      out[w,m] = sum_n [ap[w] != n] * g[n,w,m] * nm[n,m]   (downlink layout)
    """
    w = ap.shape[0]
    n, m, g_shape = _gain_dims(g_raw, uplink, w)
    dev = ap.device
    _check("ap", ap, torch.int32, (w,), dev)
    _check("nm_table", nm_table, torch.float32, (n, m), dev)
    _check("g_raw", g_raw, torch.float32, g_shape, dev)
    if dev.type != "cuda":
        return noma_ap_contract_plain(ap, nm_table, g_raw, uplink)
    out = torch.empty((w, m), dtype=torch.float32, device=dev)
    if w == 0 or m == 0:
        return out
    rc = build.load().noma_ap_contract(
        _ptr(ap), _ptr(nm_table), _ptr(g_raw), _ptr(out), w, n, m,
        int(uplink), dev.index, _stream(dev))
    _raise_on(rc, "noma_ap_contract")
    LAUNCHES["noma_ap_contract"] += 1
    return out


def noma_ap_contract_plain(ap, nm_table, g_raw, uplink: bool = True) -> torch.Tensor:
    other = _other_cell(ap, nm_table.shape[0])
    if uplink:
        return torch.where(other[:, :, None], g_raw * nm_table[None, :, :], 0.0).sum(1)
    return torch.where(other.T[:, :, None], g_raw * nm_table[:, None, :], 0.0).sum(0)


# -- composition -----------------------------------------------------------------
def segment_table(values, ap, n_aps: int) -> torch.Tensor:
    """(N, M) per-AP segment sum: sum_w [ap[w] == n] * values[w, m]. The
    gain-free tables (forward-downlink B, backward-uplink C). A fixed-order
    reduction rather than index_add_, whose atomics sum in an order that
    changes from run to run on the card."""
    own = ap[None, :] == torch.arange(n_aps, device=ap.device, dtype=ap.dtype)[:, None]
    return torch.where(own[:, :, None], values[None, :, :], 0.0).sum(1)


def _csr(csr, n_r: int, n_s: int, block_r: int, block_s: int, device):
    if csr is not None:
        return csr
    return dense_csr(-(-n_r // block_r), -(-n_s // block_s), device)


def noma_pairwise_kernel(own_u, own_v, w_intra, w_power, g_raw, ap_u, ap_v,
                         descending: bool = True, uplink: bool = True,
                         block_u: int = BLOCK_U, block_v: int = BLOCK_V,
                         csr=None):
    """Cell-block pairwise reduction: (intra (U, M), inter (U, M)).

    csr is the forward (row_ptr, col) of a CellLayout, or None for the dense
    schedule. g_raw is (V, N, M) uplink or (N, U, M) downlink."""
    bu, bv = min(block_u, own_u.shape[0]), min(block_v, own_v.shape[0])
    row_ptr, col = _csr(csr, own_u.shape[0], own_v.shape[0], bu, bv, own_u.device)
    intra = noma_cell_intra(own_u, own_v, w_intra, ap_u, ap_v, row_ptr, col,
                            bu, bv, descending)
    if uplink:
        a_nm = noma_per_ap(ap_v, w_power, g_raw, uplink=True)
        inter = a_nm.index_select(0, ap_u.long())
    else:
        b_nm = segment_table(w_power, ap_v, g_raw.shape[0])
        inter = noma_ap_contract(ap_u, b_nm, g_raw, uplink=False)
    return intra, inter


def noma_pairwise_bwd_kernel(own_u, own_v, g_raw, ap_u, ap_v, d_intra, d_inter,
                             descending: bool = True, uplink: bool = True,
                             block_u: int = BLOCK_U, block_v: int = BLOCK_V,
                             csr=None):
    """VJP of noma_pairwise_kernel w.r.t. (w_intra, w_power): (V, M) each.

    The intra cotangent is the same kernel with receiver and streamed roles
    swapped and the SIC comparison flipped, over the backward CSR (keyed by
    v-block). The inter cotangent mirrors the forward factorization: uplink
    contracts C = segment_table(d_inter) against the raw gain, downlink
    takes rows of the per-AP table D built by noma_per_ap."""
    bu, bv = min(block_u, own_u.shape[0]), min(block_v, own_v.shape[0])
    row_ptr, col = _csr(csr, own_v.shape[0], own_u.shape[0], bv, bu, own_u.device)
    d_wi = noma_cell_intra(own_v, own_u, d_intra, ap_v, ap_u, row_ptr, col,
                           bv, bu, not descending)
    if uplink:
        c_nm = segment_table(d_inter, ap_u, g_raw.shape[1])
        d_wp = noma_ap_contract(ap_v, c_nm, g_raw, uplink=True)
    else:
        d_nm = noma_per_ap(ap_u, d_inter, g_raw, uplink=False)
        d_wp = d_nm.index_select(0, ap_v.long())
    return d_wi, d_wp
