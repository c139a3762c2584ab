"""Inference-delay + energy models and the weighted utility (paper eqs. 1-22).

Differentiable in the continuous variables (beta, p, r); the split index
enters through precomputed per-split constants. A fleet env (leading member
dim B) gives per-user terms (B, U) and a utility (B,); its split index is a
Python int shared by the fleet or a (B,) tensor, one split per member. Python-float constant
products are written in the reference's order, so they fold to the same
float32 values before meeting a tensor.
"""
from __future__ import annotations

import torch

from repro_torch.core import channel
from repro_torch.core.types import EccWeights, GdVars, ModelProfile, NetworkEnv, Tensor, lam


def _at(x: Tensor, s) -> Tensor:
    """x[s] for a Python int or a device scalar; a device scalar is taken
    with index_select, which needs no host read. For a (B,) tensor of
    per-member splits, x[s] as a (B, 1) column against (B, U) terms."""
    if isinstance(s, Tensor):
        if s.ndim == 1:
            return x.index_select(0, s.long())[:, None]
        return x.index_select(0, s.long().reshape(1))[0]
    return x[s]


def split_constants(prof: ModelProfile, s) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(f_device, f_edge, w_up_bits, m_down_bits) for split index s in 0..F
    (a Python int, a device scalar, or a (B,) tensor of per-member splits)."""
    pre = prof.prefix_flops()
    suf = prof.suffix_flops()
    return _at(pre, s), _at(suf, s), _at(prof.w, s), _at(prof.m_down, s)


def delay_energy(env: NetworkEnv, prof: ModelProfile, s, v: GdVars,
                 rates: tuple[Tensor, Tensor] | None = None,
                 backend: str | None = None, layout=None) -> tuple[Tensor, Tensor]:
    """Per-user (T_i, E_i): paper eqs. (12) and (17)."""
    comp = env.comp
    f_dev, f_edge, w_up, m_dn = split_constants(prof, s)
    if rates is None:
        r_up, r_dn = channel.user_rates(env, v.beta_up, v.beta_dn, v.p_up,
                                        v.p_dn, backend=backend, layout=layout)
    else:
        r_up, r_dn = rates
    speed_edge = lam(v.r, comp) * comp.c_min_edge

    t_dev = f_dev / comp.c_device                       # eq. (1)
    t_edge = f_edge / speed_edge                        # eq. (3)
    t_up = w_up / r_up                                  # eq. (7)
    t_dn = m_dn / r_dn                                  # eq. (10)
    T = t_dev + t_edge + t_up + t_dn                    # eq. (12)

    e_dev = comp.xi_device * comp.c_device**2 * comp.phi_device * f_dev    # eq. (13)
    e_up = v.p_up * t_up                                                   # eq. (14)
    e_edge = comp.xi_edge * speed_edge**2 * comp.phi_edge * f_edge         # eq. (16)
    e_dn = v.p_dn * t_dn                                                   # eq. (15)
    E = e_dev + e_up + e_edge + e_dn                    # eq. (17)
    return T, E


def utility(env: NetworkEnv, prof: ModelProfile, s, v: GdVars, w: EccWeights,
            backend: str | None = None, layout=None) -> Tensor:
    """Gamma_s = sum_i omega_T^i T_i + omega_E^i E_i  (paper eq. 22); per
    member for a fleet."""
    T, E = delay_energy(env, prof, s, v, backend=backend, layout=layout)
    return torch.sum(w.w_T * T + w.w_E * E, dim=-1)


def per_user_utility(env: NetworkEnv, prof: ModelProfile, s, v: GdVars,
                     w: EccWeights, backend: str | None = None,
                     layout=None) -> Tensor:
    T, E = delay_energy(env, prof, s, v, backend=backend, layout=layout)
    return w.w_T * T + w.w_E * E
