"""NOMA channel model: environment sampling, SINR and achievable rates.

Implements paper eqs. (5)-(10):
  * uplink SIC at the AP: stronger users decoded first, so user i is interfered
    by same-cell users on the same subchannel with *weaker* own-cell gain,
    plus all other-cell users transmitting on that subchannel (inter-cell),
    plus noise.
  * downlink SIC at the user: weaker users decode first; user i is interfered
    by same-cell users with *stronger* gain, plus other APs' transmissions on
    the subchannel.

The relaxed subchannel variable beta[u, m] in [0, 1] (rows sum to 1) scales both
the interference a user causes and the bandwidth share it gets (Corollary 1).

Two SINR backends: "einsum" is plain tensor algebra and materializes the
(U, U, M) pairwise comparison; "kernel" runs the pairwise reductions through
the hand-written kernels of repro_torch.kernels (on the CPU, their plain
twins), differentiable in (beta, p) with the channel gains as constants.

Every function takes a fleet env too (planning.stack_envs: each tensor
leads with B), with the variables leading with B as well. The einsum
backend then holds a (B, U, U, M) tensor: it is for test sizes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import (
    LOG2,
    ComputeConstants,
    NetworkEnv,
    RadioConstants,
    Tensor,
)
from repro_torch.device import resolve_device

SINR_BACKENDS = ("einsum", "kernel")
_SINR_BACKEND = "einsum"


def set_sinr_backend(backend: str) -> str:
    """Select the default SINR backend; returns the previous one. The solver
    and the engine always pass their backend explicitly."""
    global _SINR_BACKEND
    _check_backend(backend)
    prev, _SINR_BACKEND = _SINR_BACKEND, backend
    return prev


def _check_backend(backend: str) -> None:
    if backend not in SINR_BACKENDS:
        raise ValueError(f"backend must be one of {SINR_BACKENDS}, got {backend!r}")


def make_env(
    n_users: int,
    n_aps: int,
    n_sub: int,
    radio: RadioConstants = RadioConstants(),
    comp: ComputeConstants = ComputeConstants(),
    *,
    seed: int = 0,
    device=None,
) -> NetworkEnv:
    """Sample user/AP positions and i.i.d. Rayleigh fading per subchannel,
    from a torch.Generator seeded with ``seed`` on ``device`` (None: the
    card). The draws differ from the JAX sampler's; the distribution is
    the same."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    side = radio.cell_radius_m * max(1.0, n_aps**0.5)
    ap_pos = torch.rand((n_aps, 2), generator=gen, device=dev) * side
    user_pos = torch.rand((n_users, 2), generator=gen, device=dev) * side
    d = torch.linalg.norm(user_pos[:, None, :] - ap_pos[None, :, :], dim=-1)
    d = torch.clamp_min(d, 1.0)
    path = d ** (-radio.path_loss_exp)  # (U, N)
    # Rayleigh fading: |h|^2 ~ Exp(1), i.i.d. per (user, AP, subchannel).
    shape = (n_users, n_aps, n_sub)
    fad_up = torch.empty(shape, device=dev).exponential_(generator=gen)
    fad_dn = torch.empty(shape, device=dev).exponential_(generator=gen)
    g_up = path[:, :, None] * fad_up
    g_dn = (path[:, :, None] * fad_dn).transpose(0, 1).contiguous()  # (N, U, M)
    # Nearest-AP policy == maximum average channel gain.
    ap = torch.argmax(path, dim=1).to(torch.int32)
    return NetworkEnv(g_up=g_up, g_dn=g_dn, ap=ap, radio=radio, comp=comp)


def _cell_onehot(env: NetworkEnv) -> Tensor:
    """([B,] U, N) one-hot of the serving AP."""
    return F.one_hot(env.ap.long(), env.n_aps).to(env.g_up.dtype)


def uplink_sinr(env: NetworkEnv, beta_up: Tensor, p_up: Tensor,
                backend: str | None = None, layout=None) -> Tensor:
    """Paper eq. (5). Returns SINR (U, M). layout: optional CellLayout
    (kernel backend only) restricting the SIC grid to same-cell tiles."""
    backend = _SINR_BACKEND if backend is None else backend
    _check_backend(backend)
    own = env.own_gain_up()                      # (U, M) gain to own AP
    tx = beta_up * p_up[..., None]                # (U, M) effective tx power
    if backend == "kernel":
        from repro_torch.kernels import ops
        # The kernels treat the gains as constants; detach the own-gain
        # uses outside them too, so the env gradient is coherently zero.
        own = own.detach()
        intra, inter = ops.noma_pairwise_up(env, tx, layout=layout)
    else:
        cell = _cell_onehot(env)                  # (U, N)
        # Inter-cell interference received at AP n from users NOT in cell n,
        # masked directly (no subtraction: fp32-safe).
        inter_at = torch.einsum("...vn,...vm,...vnm->...nm", 1.0 - cell, tx,
                                env.g_up)         # (N, M)
        inter = torch.einsum("...un,...nm->...um", cell, inter_at)
        same = env.same_cell().to(own.dtype)      # (U, U)
        # Intra-cell: same-cell users with weaker own-gain (decoded after me).
        weaker = (own[..., None, :, :] < own[..., :, None, :]).to(own.dtype)  # (U, V, M)
        intra = torch.einsum("...uvm,...vm->...um", weaker * same[..., None], tx * own)
    sig = p_up[..., None] * own
    return sig / (intra + inter + env.noise_up)


def uplink_rates(env: NetworkEnv, beta_up: Tensor, p_up: Tensor,
                 backend: str | None = None, layout=None) -> Tensor:
    """Paper eq. (6): per-(user, subchannel) rate in bit/s."""
    sinr = uplink_sinr(env, beta_up, p_up, backend=backend, layout=layout)
    bw = env.radio.bandwidth_up_hz / env.n_sub
    return beta_up * bw * torch.log1p(sinr) / LOG2


def downlink_sinr(env: NetworkEnv, beta_dn: Tensor, p_dn: Tensor,
                  backend: str | None = None, layout=None) -> Tensor:
    """Paper eq. (8). Returns SINR (U, M). layout as in uplink_sinr."""
    backend = _SINR_BACKEND if backend is None else backend
    _check_backend(backend)
    own = env.own_gain_dn()                       # (U, M) gain my AP -> me
    tx = beta_dn * p_dn[..., None]                # (U, M) power my AP spends on me
    if backend == "kernel":
        from repro_torch.kernels import ops
        own = own.detach()
        intra, inter = ops.noma_pairwise_dn(env, tx, layout=layout)
        intra = intra * own
    else:
        cell = _cell_onehot(env)                  # (U, N)
        ap_tx = torch.einsum("...un,...um->...nm", cell, tx)   # (N, M) total AP tx power
        # Interference from *other* APs received at me, masked directly.
        g_all = env.g_dn.transpose(-3, -2)        # (U, N, M)
        inter = torch.einsum("...nm,...unm,...un->...um", ap_tx, g_all, 1.0 - cell)
        # Intra-cell: same-cell users with *stronger* gain (decoded after me).
        same = env.same_cell().to(own.dtype)
        stronger = (own[..., None, :, :] > own[..., :, None, :]).to(own.dtype)
        intra = torch.einsum("...uvm,...vm->...um", stronger * same[..., None], tx) * own
    sig = p_dn[..., None] * own
    return sig / (intra + inter + env.noise_dn)


def downlink_rates(env: NetworkEnv, beta_dn: Tensor, p_dn: Tensor,
                   backend: str | None = None, layout=None) -> Tensor:
    """Paper eq. (9)."""
    sinr = downlink_sinr(env, beta_dn, p_dn, backend=backend, layout=layout)
    bw = env.radio.bandwidth_dn_hz / env.n_sub
    return beta_dn * bw * torch.log1p(sinr) / LOG2


def _rate_floor(like: Tensor) -> Tensor:
    """The 1e-9 rate floor as a 0-d tensor of like's dtype and device, made
    by a fill kernel (no blocking host-to-device copy)."""
    return torch.full((), 1e-9, dtype=like.dtype, device=like.device)


def user_rates(env: NetworkEnv, beta_up: Tensor, beta_dn: Tensor, p_up: Tensor,
               p_dn: Tensor, backend: str | None = None,
               layout=None) -> tuple[Tensor, Tensor]:
    """Total uplink/downlink rate per user (bit/s), floored at 1e-9. The
    floor is a binary maximum, whose gradient splits evenly at a tie, as
    the reference's does; it is built by a fill (_rate_floor), not copied
    from the host."""
    r_up = torch.sum(uplink_rates(env, beta_up, p_up, backend=backend,
                                  layout=layout), dim=-1)
    r_dn = torch.sum(downlink_rates(env, beta_dn, p_dn, backend=backend,
                                    layout=layout), dim=-1)
    floor = _rate_floor(r_up)
    return torch.maximum(r_up, floor), torch.maximum(r_dn, floor)


def oma_rates(env: NetworkEnv, p_up: Tensor, p_dn: Tensor) -> tuple[Tensor, Tensor]:
    """OMA baseline: each user gets a dedicated share of its best subchannel,
    TDMA-style equal split within the cell."""
    own_up = env.own_gain_up()
    own_dn = env.own_gain_dn()
    counts = torch.sum(env.same_cell(), dim=-1).to(own_up.dtype)
    bw_up = env.radio.bandwidth_up_hz / counts
    bw_dn = env.radio.bandwidth_dn_hz / counts
    g_up = torch.amax(own_up, dim=-1)
    g_dn = torch.amax(own_dn, dim=-1)
    snr_up = p_up * g_up / (env.noise_up * env.n_sub)   # full-band noise share
    snr_dn = p_dn * g_dn / (env.noise_dn * env.n_sub)
    r_up = bw_up * torch.log1p(snr_up) / LOG2
    r_dn = bw_dn * torch.log1p(snr_dn) / LOG2
    floor = _rate_floor(r_up)
    return torch.maximum(r_up, floor), torch.maximum(r_dn, floor)
