"""Differentiable wrappers around the NOMA kernels.

torch.autograd.Functions carry the uplink and downlink pairwise terms: the
forward runs noma_pairwise_kernel, the backward re-streams the same raw gain
through noma_pairwise_bwd_kernel (with a CellLayout, over the same tile set
reordered by v-block). Only the own gains and the layout are kept for
backward; the channel gains are constants of the GD path and get no
gradient, and neither does the env or the layout.
"""
from __future__ import annotations

import torch

from repro_torch.core import channel
from repro_torch.core.types import NetworkEnv
from repro_torch.kernels.cells import CellLayout
from repro_torch.kernels.noma_rates import (
    BLOCK_U,
    BLOCK_V,
    noma_pairwise_bwd_kernel,
    noma_pairwise_kernel,
)


def _layout_blocks(layout, env, block_u, block_v):
    """The intra block sizes: a CellLayout's own blocks are authoritative
    (its tiles are block-granular). A layout built for another user count
    would give wrong answers silently, so it is refused."""
    if layout is None:
        return block_u, block_v
    if layout.n_users != env.n_users:
        raise ValueError(
            f"CellLayout built for U={layout.n_users}, env has "
            f"U={env.n_users}; rebuild with build_cell_layout(env, ...).")
    return layout.block_u, layout.block_v


def _inputs(env: NetworkEnv, uplink: bool):
    """Kernel inputs of the (used) env: own-AP gains, the raw gains (uplink
    (U, N, M), downlink (N, U, M)) and the int32 AP ids."""
    own = (env.own_gain_up() if uplink else env.own_gain_dn()).float().contiguous()
    g_raw = (env.g_up if uplink else env.g_dn).float().contiguous()
    return own, g_raw, env.ap.to(torch.int32).contiguous()


def _sort_in(x, layout):
    return x if layout is None else x.index_select(0, layout.perm)


def _sort_out(x, layout):
    return x if layout is None else x.index_select(0, layout.inv)


def _fwd_csr(layout):
    return None if layout is None else (layout.fwd_row_ptr, layout.fwd_col)


def _bwd_csr(layout):
    return None if layout is None else (layout.bwd_row_ptr, layout.bwd_col)


class _Pairwise(torch.autograd.Function):
    """(intra, inter) of eq. (5) (uplink) or eq. (8) (downlink) as functions
    of tx = beta * p. Uplink feeds the kernel w_intra = tx * own and
    w_power = tx; downlink feeds tx to both (the receiver-side own-gain
    factor of eq. 8 is applied by the caller)."""

    @staticmethod
    def forward(ctx, tx, env, layout, uplink, block_u, block_v):
        used = env if layout is None else layout.env
        own, g_raw, ap = _inputs(used, uplink)
        tx = _sort_in(tx.float(), layout).contiguous()
        w_intra = (tx * own) if uplink else tx
        intra, inter = noma_pairwise_kernel(
            own, own, w_intra, tx, g_raw, ap, ap, descending=uplink,
            uplink=uplink, block_u=block_u, block_v=block_v,
            csr=_fwd_csr(layout))
        ctx.save_for_backward(own)
        ctx.env, ctx.layout, ctx.uplink = env, layout, uplink
        ctx.blocks = (block_u, block_v)
        return _sort_out(intra, layout), _sort_out(inter, layout)

    @staticmethod
    def backward(ctx, d_intra, d_inter):
        (own,) = ctx.saved_tensors
        layout, uplink = ctx.layout, ctx.uplink
        used = ctx.env if layout is None else layout.env
        _, g_raw, ap = _inputs(used, uplink)
        d_i, d_x = (torch.zeros_like(own) if c is None
                    else _sort_in(c.float(), layout).contiguous()
                    for c in (d_intra, d_inter))
        d_wi, d_wp = noma_pairwise_bwd_kernel(
            own, own, g_raw, ap, ap, d_i, d_x, descending=uplink,
            uplink=uplink, block_u=ctx.blocks[0], block_v=ctx.blocks[1],
            csr=_bwd_csr(layout))
        d_tx = (d_wi * own + d_wp) if uplink else (d_wi + d_wp)
        return _sort_out(d_tx, layout), None, None, None, None, None


def noma_pairwise_up(env: NetworkEnv, tx: torch.Tensor,
                     block_u: int = BLOCK_U, block_v: int = BLOCK_V,
                     layout: CellLayout | None = None):
    """Uplink (intra, inter) interference terms of eq. (5): the exact
    denominators channel.uplink_sinr consumes. Differentiable in tx. With a
    CellLayout the intra grid covers only the same-cell block-diagonal
    tiles; results come back in the caller's user order either way."""
    block_u, block_v = _layout_blocks(layout, env, block_u, block_v)
    return _Pairwise.apply(tx, env, layout, True, block_u, block_v)


def noma_pairwise_dn(env: NetworkEnv, tx: torch.Tensor,
                     block_u: int = BLOCK_U, block_v: int = BLOCK_V,
                     layout: CellLayout | None = None):
    """Downlink (intra, inter) terms of eq. (8). The intra term is
    sum_v stronger*same * tx[v]; the caller multiplies by own gain."""
    block_u, block_v = _layout_blocks(layout, env, block_u, block_v)
    return _Pairwise.apply(tx, env, layout, False, block_u, block_v)


def noma_uplink_rates(env: NetworkEnv, beta_up, p_up,
                      layout: CellLayout | None = None):
    """Kernel-backed uplink rates, eq. (5)-(6): channel.uplink_rates with
    backend="kernel". Gains are constants."""
    return channel.uplink_rates(env, beta_up, p_up, backend="kernel", layout=layout)


def noma_downlink_rates(env: NetworkEnv, beta_dn, p_dn,
                        layout: CellLayout | None = None):
    """Kernel-backed downlink rates, eq. (8)-(9): channel.downlink_rates
    with backend="kernel". Gains are constants."""
    return channel.downlink_rates(env, beta_dn, p_dn, backend="kernel", layout=layout)
