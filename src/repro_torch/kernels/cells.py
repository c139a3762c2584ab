"""CellLayout: host-side AP-sort precompute for the cell-block-sparse NOMA
kernels.

The intra/SIC term only couples same-cell user pairs, so with users sorted
by serving AP the same-cell mask is block-diagonal and the intra kernel
(kernels/noma_rates.py) only visits the per-cell diagonal tiles: pairwise
cost scales as sum-of-cell-sizes^2 instead of U^2, forward and backward.
The sort is paid once per env: the (U, N, M) gains are permuted here, and
per call only the (U, M) decision variables cross the permutation.

The tile sets are handed to the kernel in CSR form, one run per receiver
block (``row_ptr[b]:row_ptr[b+1]`` indexes ``col``, the streamed blocks of
receiver block b), so that one thread block owns one output block and walks
its run in order: no atomics and the same sum on every run. The forward CSR
is keyed by u-block, the backward CSR by v-block.

    layout = build_cell_layout(env)                       # once per env
    rates  = channel.uplink_rates(env, beta, p, backend="kernel",
                                  layout=layout)          # every iteration

Rebuild the layout whenever env.ap or the gains change, and when the block
sizes change (the tiles are built from the clamped blocks min(block, U)).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import NetworkEnv
from repro_torch.kernels.noma_rates import BLOCK_U, BLOCK_V, dense_tile_count


@dataclasses.dataclass(frozen=True)
class CellLayout:
    """AP-sorted view of a NetworkEnv plus the block-diagonal tile sets.

    env      NetworkEnv with users stably sorted by serving AP.
    perm     (U,) int64: sorted[i] = original[perm[i]].
    inv      (U,) int64: original[i] = sorted[inv[i]].
    tile_u/tile_v          forward tile list, sorted by u-block.
    bwd_tile_v/bwd_tile_u  the same tile set sorted by v-block.
    fwd_row_ptr/fwd_col    forward CSR: per u-block, its v-blocks.
    bwd_row_ptr/bwd_col    backward CSR: per v-block, its u-blocks.
    """

    env: NetworkEnv
    perm: torch.Tensor
    inv: torch.Tensor
    tile_u: torch.Tensor
    tile_v: torch.Tensor
    bwd_tile_v: torch.Tensor
    bwd_tile_u: torch.Tensor
    fwd_row_ptr: torch.Tensor
    fwd_col: torch.Tensor
    bwd_row_ptr: torch.Tensor
    bwd_col: torch.Tensor
    n_tiles: int = 0
    block_u: int = BLOCK_U
    block_v: int = BLOCK_V

    @property
    def n_users(self) -> int:
        return self.env.n_users

    def dense_n_tiles(self) -> int:
        """Tile count of the dense (no-layout) schedule for this env."""
        return dense_tile_count(self.n_users, self.n_users, self.block_u,
                                self.block_v)


def cell_tiles(ap_sorted: np.ndarray, block_u: int, block_v: int):
    """Block-diagonal tile lists for an AP-sorted id vector.

    Returns (tile_u, tile_v, bwd_tile_v, bwd_tile_u) int32 arrays: every
    (u-block, v-block) pair that contains at least one same-cell pair, each
    exactly once (adjacent cells sharing a boundary block are deduped), the
    forward list sorted by u-block, the backward list by v-block."""
    counts = np.bincount(ap_sorted)
    ends = np.cumsum(counts)
    starts = ends - counts
    tiles = set()
    for s, e in zip(starts, ends):
        if e <= s:
            continue  # empty cell
        ub = range(s // block_u, (e - 1) // block_u + 1)
        vb = range(s // block_v, (e - 1) // block_v + 1)
        tiles.update((i, j) for i in ub for j in vb)
    fwd = sorted(tiles)
    bwd = sorted(tiles, key=lambda t: (t[1], t[0]))
    tu = np.asarray([t[0] for t in fwd], dtype=np.int32)
    tv = np.asarray([t[1] for t in fwd], dtype=np.int32)
    bv = np.asarray([t[1] for t in bwd], dtype=np.int32)
    bu = np.asarray([t[0] for t in bwd], dtype=np.int32)
    return tu, tv, bv, bu


def tile_csr(tile_r: np.ndarray, tile_s: np.ndarray, n_blocks_r: int):
    """(row_ptr, col) int32 of a tile list sorted by receiver block."""
    if len(tile_r) and (np.diff(tile_r) < 0).any():
        raise ValueError("tile_r must be non-decreasing")
    row_ptr = np.zeros(n_blocks_r + 1, np.int32)
    np.cumsum(np.bincount(tile_r, minlength=n_blocks_r), out=row_ptr[1:])
    return row_ptr, np.asarray(tile_s, np.int32)


def build_cell_layout(env: NetworkEnv, block_u: int = BLOCK_U,
                      block_v: int = BLOCK_V) -> CellLayout:
    """Sort users by AP and enumerate the same-cell block tiles.

    One host read of the (U,) ap vector and one permutation of the
    (U, N, M) gains per call: do this once per env, outside the solver
    loop. Blocks are clamped to U exactly as the kernels clamp them."""
    ap = env.ap.cpu().numpy()
    u = ap.shape[0]
    bu, bv = min(block_u, u), min(block_v, u)
    perm = np.argsort(ap, kind="stable")
    inv = np.argsort(perm)
    ap_sorted = ap[perm]
    tu, tv, tbv, tbu = cell_tiles(ap_sorted, bu, bv)
    fwd_ptr, fwd_col = tile_csr(tu, tv, -(-u // bu))
    bwd_ptr, bwd_col = tile_csr(tbv, tbu, -(-u // bv))
    dev = env.device

    def t(x, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)

    perm_t = t(perm, torch.int64)
    sorted_env = dataclasses.replace(
        env,
        g_up=env.g_up.index_select(0, perm_t).contiguous(),
        g_dn=env.g_dn.index_select(1, perm_t).contiguous(),
        ap=t(ap_sorted),
    )
    return CellLayout(
        env=sorted_env, perm=perm_t, inv=t(inv, torch.int64),
        tile_u=t(tu), tile_v=t(tv), bwd_tile_v=t(tbv), bwd_tile_u=t(tbu),
        fwd_row_ptr=t(fwd_ptr), fwd_col=t(fwd_col),
        bwd_row_ptr=t(bwd_ptr), bwd_col=t(bwd_col),
        n_tiles=int(tu.shape[0]), block_u=bu, block_v=bv,
    )
