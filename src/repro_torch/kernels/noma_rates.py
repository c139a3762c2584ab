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

  taken by noma_cell_intra_dense when no CellLayout is given (each cell's
  receivers against that cell's senders, found on the device), and by
  noma_cell_intra over a CSR list of (receiver block, streamed block)
  tiles with one (the same-cell block-diagonal tiles).

Every wrapper checks device, dtype, shape and contiguity. For CUDA tensors
it launches its kernel (counted in LAUNCHES) or raises; for CPU tensors it
computes its plain PyTorch twin, the function of the same name with the
suffix ``_plain``, which is also what the kernel is held against on the card.

Fleets: noma_cell_intra_dense, noma_per_ap, noma_ap_contract, their twins
and segment_table also take every operand with a leading member dim B (the
JAX package runs its kernels under jax.vmap). One launch covers all B
members and counts once; a single environment is the B = 1 launch of the
same kernel. The launch geometry depends on (U, N, M) alone, so member b of
a fleet launch has the same bits as a launch on member b alone. The CSR
kernel (noma_cell_intra, a CellLayout's schedule) stays single-environment.
"""
from __future__ import annotations

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
# Most fleet members a launch takes: the member is grid z.
MAX_MEMBERS = 65535


def _fleet_of_one(*ts):
    """Each tensor with a leading member dim of 1 (a view)."""
    return tuple(t.unsqueeze(0) for t in ts)


def _check_members(b: int) -> None:
    if not 1 <= b <= MAX_MEMBERS:
        raise ValueError(f"a launch takes 1 to {MAX_MEMBERS} fleet members, got {b}")


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
    build.check("own_r", own_r, torch.float32, (r, m), dev)
    build.check("own_s", own_s, torch.float32, (s, m), dev)
    build.check("w_s", w_s, torch.float32, (s, m), dev)
    build.check("ap_r", ap_r, torch.int32, (r,), dev)
    build.check("ap_s", ap_s, torch.int32, (s,), dev)
    build.check("row_ptr", row_ptr, torch.int32, (n_rb + 1,), dev)
    build.check("col", col, torch.int32, (col.shape[0],), dev)
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
    rc = build.load("noma_rates").noma_cell_intra(
        build.ptr(own_r), build.ptr(own_s), build.ptr(w_s), build.ptr(ap_r), build.ptr(ap_s),
        build.ptr(row_ptr), build.ptr(col), build.ptr(out), r, s, m, block_r, block_s,
        _rows_per_thread(block_r), int(descending), dev.index, build.stream(dev))
    build.raise_on(rc, "noma_cell_intra")
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
    return _sic_select(own_r, own_s, w_s, pair, descending)


def _sic_select(own_r, own_s, w_s, pair, descending: bool) -> torch.Tensor:
    """sum_s pair[r,s] * cmp(own_s[s,m], own_r[r,m]) * w_s[s,m] through an
    (R, S, M) select, per leading member index."""
    if descending:
        cmp = own_s[..., None, :, :] < own_r[..., :, None, :]
    else:
        cmp = own_s[..., None, :, :] > own_r[..., :, None, :]
    keep = cmp & pair[..., None]
    return torch.where(keep, w_s[..., None, :, :], 0.0).sum(-2)


# -- kernel 1, dense schedule: per-cell work -------------------------------------
# One thread block (LANES x WARPS threads) per (LANES-wide m block, cell,
# receiver-chunk slot). A chunk is DENSE_CHUNK receivers of the cell in
# ascending id, DENSE_ROWS a thread in registers; the cell's members are
# found DENSE_WINDOW ids at a time by a block-wide compaction of the AP ids,
# and its senders stream in DENSE_TILE-sender tiles through a
# double-buffered cp.async ring in static shared memory
# (intra_dense_smem_bytes). A cell gets dense_chunks_per_cell slots: enough
# for a cell DENSE_SKEW times the mean size to spread over blocks of its
# own; a slot of a larger cell takes several chunks in turn, and a slot
# past its cell's chunks exits.
DENSE_ROWS = 4
DENSE_CHUNK = WARPS * DENSE_ROWS
DENSE_TILE = 32
DENSE_WINDOW = WARPS * 8 * LANES
DENSE_SKEW = 3


def intra_dense_smem_bytes() -> int:
    """Static shared memory of one dense-intra block: the chunk's receiver
    ids, a window's sender ids, the per-warp counts, and two (own_s, w_s)
    tile pairs of (DENSE_TILE, LANES) floats."""
    return 4 * (DENSE_CHUNK + DENSE_WINDOW + WARPS + 2 * 2 * DENSE_TILE * LANES)


def dense_chunks_per_cell(n_r: int, n_aps: int) -> int:
    """Receiver-chunk slots a cell gets on the dense schedule."""
    most = max(1, -(-n_r // DENSE_CHUNK))
    skewed = -(-DENSE_SKEW * n_r // (n_aps * DENSE_CHUNK))
    return max(1, min(most, skewed))


def noma_cell_intra_dense(own_r, own_s, w_s, ap_r, ap_s, n_aps: int,
                          descending: bool = True) -> torch.Tensor:
    """SIC intra reduction over every same-cell pair, (R, M):

      out[r,m] = sum_s [ap_r[r] == ap_s[s]] * cmp(own_s, own_r) * w_s[s,m]

    The dense schedule (no CellLayout): the kernel visits only same-cell
    (r, s) pairs, finding each cell's members on the device. own_r (R, M),
    own_s/w_s (S, M) float32; ap_r (R,), ap_s (S,) int32 AP ids in
    [0, n_aps) (not checked: that would sync the host; a receiver with an
    id outside is never written). cmp is '<' when descending (uplink SIC
    order), '>' otherwise. With a leading member dim B on every operand,
    out is (B, R, M), one launch. Counted under LAUNCHES["noma_cell_intra"]."""
    single = own_r.ndim == 2
    if single:
        own_r, own_s, w_s, ap_r, ap_s = _fleet_of_one(own_r, own_s, w_s, ap_r, ap_s)
    b, r, m = own_r.shape
    s = own_s.shape[-2]
    dev = own_r.device
    build.check("own_r", own_r, torch.float32, (b, r, m), dev)
    build.check("own_s", own_s, torch.float32, (b, s, m), dev)
    build.check("w_s", w_s, torch.float32, (b, s, m), dev)
    build.check("ap_r", ap_r, torch.int32, (b, r), dev)
    build.check("ap_s", ap_s, torch.int32, (b, s), dev)
    _check_members(b)
    if n_aps < 1:
        raise ValueError(f"n_aps must be >= 1, got {n_aps}")
    if dev.type != "cuda":
        out = noma_cell_intra_dense_plain(own_r, own_s, w_s, ap_r, ap_s, n_aps, descending)
    else:
        out = torch.empty((b, r, m), dtype=torch.float32, device=dev)
        if r and m:
            rc = build.load("noma_rates").noma_cell_intra_dense(
                build.ptr(own_r), build.ptr(own_s), build.ptr(w_s), build.ptr(ap_r),
                build.ptr(ap_s), build.ptr(out), b, r, s, m, n_aps,
                dense_chunks_per_cell(r, n_aps), int(descending), dev.index, build.stream(dev))
            build.raise_on(rc, "noma_cell_intra_dense")
            LAUNCHES["noma_cell_intra"] += 1
    return out[0] if single else out


def noma_cell_intra_dense_plain(own_r, own_s, w_s, ap_r, ap_s, n_aps: int,
                                descending: bool = True) -> torch.Tensor:
    """Plain twin of noma_cell_intra_dense: the ([B,] R, S, M) select over
    all same-cell pairs (n_aps only bounds the ids)."""
    return _sic_select(own_r, own_s, w_s, ap_r[..., :, None] == ap_s[..., None, :], descending)


# -- kernel 2: per-AP table ------------------------------------------------------
# The w reduction is split across the blocks of a thread-block cluster: a
# cluster of `split` blocks (LANES x WARPS threads each) per output tile of
# (PER_AP_GROUP APs, LANES-wide m block); block r of a cluster sums the w range
# [r * w_chunk, min(W, (r + 1) * w_chunk)) and block 0 adds the partial
# tiles in rank order (csrc/noma_rates.cu). split is at most the portable
# cluster size, PER_AP_MAX_SPLIT, and a block takes at least PER_AP_MIN_W
# w's (8 a warp), so small W runs in fewer blocks. The geometry depends on
# the shapes alone, so the summation order, and with it the result's bits,
# is the same on every launch.
PER_AP_MAX_SPLIT = 8
PER_AP_MIN_W = WARPS * 8
PER_AP_GROUP = 2


def per_ap_geometry(w: int) -> tuple[int, int]:
    """(split, w_chunk) of the per_ap launch for W users: a grid of
    (ceil(N / PER_AP_GROUP) * ceil(M / LANES), split) blocks."""
    split = max(1, min(PER_AP_MAX_SPLIT, -(-w // PER_AP_MIN_W)))
    return split, max(1, -(-w // split))


def _gain_dims(g_raw, uplink: bool, w: int):
    """(N, M, one member's gain shape) of a raw gain, with or without a
    leading member dim: uplink (W, N, M), downlink (N, W, M)."""
    n = g_raw.shape[-2] if uplink else g_raw.shape[-3]
    m = g_raw.shape[-1]
    return n, m, ((w, n, m) if uplink else (n, w, m))


def noma_per_ap(ap, wgt, g_raw, uplink: bool = True) -> torch.Tensor:
    """Other-cell per-AP reduction, (N, M):

      out[n,m] = sum_w [ap[w] != n] * wgt[w,m] * g[w,n,m]   (uplink layout)
      out[n,m] = sum_w [ap[w] != n] * wgt[w,m] * g[n,w,m]   (downlink layout)

    With a leading member dim B on every operand, out is (B, N, M), one
    launch."""
    single = ap.ndim == 1
    if single:
        ap, wgt, g_raw = _fleet_of_one(ap, wgt, g_raw)
    b, w = ap.shape
    n, m, g_shape = _gain_dims(g_raw, uplink, w)
    dev = ap.device
    build.check("ap", ap, torch.int32, (b, w), dev)
    build.check("wgt", wgt, torch.float32, (b, w, m), dev)
    build.check("g_raw", g_raw, torch.float32, (b, *g_shape), dev)
    _check_members(b)
    if dev.type != "cuda":
        out = noma_per_ap_plain(ap, wgt, g_raw, uplink)
    else:
        out = torch.empty((b, n, m), dtype=torch.float32, device=dev)
        if n and m:
            rc = build.load("noma_rates").noma_per_ap(
                build.ptr(ap), build.ptr(wgt), build.ptr(g_raw), build.ptr(out), b, w, n, m,
                *per_ap_geometry(w), int(uplink), dev.index, build.stream(dev))
            build.raise_on(rc, "noma_per_ap")
            LAUNCHES["noma_per_ap"] += 1
    return out[0] if single else out


def _other_cell(ap, n_aps: int):
    """([B,] W, N) bool: [ap[w] != n]."""
    return ap[..., :, None] != torch.arange(n_aps, device=ap.device, dtype=ap.dtype)


def noma_per_ap_plain(ap, wgt, g_raw, uplink: bool = True) -> torch.Tensor:
    n = g_raw.shape[-2] if uplink else g_raw.shape[-3]
    other = _other_cell(ap, n)
    if uplink:
        return torch.where(other[..., None], wgt[..., :, None, :] * g_raw, 0.0).sum(-3)
    return torch.where(other.transpose(-1, -2)[..., None], g_raw * wgt[..., None, :, :],
                       0.0).sum(-2)


# -- kernel 3: per-AP contraction ------------------------------------------------
def noma_ap_contract(ap, nm_table, g_raw, uplink: bool = True) -> torch.Tensor:
    """Other-cell contraction of a per-AP table against the raw gain, (W, M):

      out[w,m] = sum_n [ap[w] != n] * g[w,n,m] * nm[n,m]   (uplink layout)
      out[w,m] = sum_n [ap[w] != n] * g[n,w,m] * nm[n,m]   (downlink layout)

    With a leading member dim B on every operand, out is (B, W, M), one
    launch."""
    single = ap.ndim == 1
    if single:
        ap, nm_table, g_raw = _fleet_of_one(ap, nm_table, g_raw)
    b, w = ap.shape
    n, m, g_shape = _gain_dims(g_raw, uplink, w)
    dev = ap.device
    build.check("ap", ap, torch.int32, (b, w), dev)
    build.check("nm_table", nm_table, torch.float32, (b, n, m), dev)
    build.check("g_raw", g_raw, torch.float32, (b, *g_shape), dev)
    _check_members(b)
    if dev.type != "cuda":
        out = noma_ap_contract_plain(ap, nm_table, g_raw, uplink)
    else:
        out = torch.empty((b, w, m), dtype=torch.float32, device=dev)
        if w and m:
            rc = build.load("noma_rates").noma_ap_contract(
                build.ptr(ap), build.ptr(nm_table), build.ptr(g_raw), build.ptr(out), b, w,
                n, m, int(uplink), dev.index, build.stream(dev))
            build.raise_on(rc, "noma_ap_contract")
            LAUNCHES["noma_ap_contract"] += 1
    return out[0] if single else out


def noma_ap_contract_plain(ap, nm_table, g_raw, uplink: bool = True) -> torch.Tensor:
    other = _other_cell(ap, nm_table.shape[-2])
    if uplink:
        return torch.where(other[..., None], g_raw * nm_table[..., None, :, :], 0.0).sum(-2)
    return torch.where(other.transpose(-1, -2)[..., None], g_raw * nm_table[..., :, None, :],
                       0.0).sum(-3)


# -- composition -----------------------------------------------------------------
def segment_table(values, ap, n_aps: int) -> torch.Tensor:
    """([B,] N, M) per-AP segment sum: sum_w [ap[w] == n] * values[w, m]. The
    gain-free tables (forward-downlink B, backward-uplink C). A fixed-order
    reduction rather than index_add_, whose atomics sum in an order that
    changes from run to run on the card."""
    own = ap[..., None, :] == torch.arange(n_aps, device=ap.device, dtype=ap.dtype)[:, None]
    return torch.where(own[..., None], values[..., None, :, :], 0.0).sum(-2)


def _take_rows(table, ap):
    """([B,] W, M): row ap[w] of the per-AP table ([B,] N, M)."""
    idx = ap.long()[..., None].expand(*ap.shape, table.shape[-1])
    return torch.gather(table, -2, idx)


def noma_pairwise_kernel(own_u, own_v, w_intra, w_power, g_raw, ap_u, ap_v,
                         descending: bool = True, uplink: bool = True,
                         block_u: int = BLOCK_U, block_v: int = BLOCK_V,
                         csr=None):
    """Cell-block pairwise reduction: (intra (U, M), inter (U, M)).

    csr is the forward (row_ptr, col) of a CellLayout, or None for the dense
    schedule (per-cell work, no tile list). g_raw is (V, N, M) uplink or
    (N, U, M) downlink; its N is the number of cells. Without csr every
    operand may lead with a member dim B (one launch a kernel)."""
    n_aps = g_raw.shape[-2] if uplink else g_raw.shape[-3]
    if csr is None:
        intra = noma_cell_intra_dense(own_u, own_v, w_intra, ap_u, ap_v, n_aps, descending)
    else:
        bu, bv = min(block_u, own_u.shape[0]), min(block_v, own_v.shape[0])
        intra = noma_cell_intra(own_u, own_v, w_intra, ap_u, ap_v, *csr, bu, bv, descending)
    if uplink:
        a_nm = noma_per_ap(ap_v, w_power, g_raw, uplink=True)
        inter = _take_rows(a_nm, ap_u)
    else:
        b_nm = segment_table(w_power, ap_v, n_aps)
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
    n_aps = g_raw.shape[-2] if uplink else g_raw.shape[-3]
    if csr is None:
        d_wi = noma_cell_intra_dense(own_v, own_u, d_intra, ap_v, ap_u, n_aps,
                                     not descending)
    else:
        bu, bv = min(block_u, own_u.shape[0]), min(block_v, own_v.shape[0])
        d_wi = noma_cell_intra(own_v, own_u, d_intra, ap_v, ap_u, *csr, bv, bu,
                               not descending)
    if uplink:
        c_nm = segment_table(d_inter, ap_u, n_aps)
        d_wp = noma_ap_contract(ap_v, c_nm, g_raw, uplink=True)
    else:
        d_nm = noma_per_ap(ap_u, d_inter, g_raw, uplink=False)
        d_wp = _take_rows(d_nm, ap_v)
    return d_wi, d_wp
