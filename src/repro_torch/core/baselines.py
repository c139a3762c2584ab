"""Evaluation baselines the paper compares against (Sec. VI):

  Device-Only    whole model on the device; no radio use.
  Edge-Only      whole model offloaded (split s=0), max power, best channel.
  Neurosurgeon   [38] latency-only split per user, OMA channel, full edge res.
  DNN-Surgery    [14] latency-only split, OMA, edge resources shared fairly.
  ECC-OMA        the paper's ECC optimizer but over OMA channels.

All return per-user (T, E) so figures can be normalized the way the paper
normalizes (to Device-Only, or to Neurosurgeon for Fig.4/5). Each takes
one environment (a fleet env raises) and runs on the env's device; the
profile is moved there. The OMA arms' arithmetic is the reference's term by
term and in its order (their energy has no phi factor, unlike
utility.delay_energy), so a per-user argmin over splits resolves near-ties
as the reference's does. Edge-Only and evaluate_plan price the NOMA rates
under the module-level SINR backend (channel.set_sinr_backend), as the
reference does; the OMA arms and Device-Only run no NOMA kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import channel
from repro_torch.core.li_gd import SYNC_EVERY
from repro_torch.core.types import (
    EccWeights,
    GdConfig,
    GdVars,
    ModelProfile,
    NetworkEnv,
    Tensor,
)
from repro_torch.core.utility import _at
from repro_torch.core.utility import delay_energy as _delay_energy

# ECC-OMA's normalized variables.
OMA_KEYS = ("p_up", "p_dn", "r")
# ECC-OMA's GD steps executed (frozen ones included) and host reads of its
# stop flag since the last reset; chip_smoke.py prints them.
COUNTS = {"steps": 0, "host_reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class Outcome(NamedTuple):
    T: Tensor   # (U,) seconds
    E: Tensor   # (U,) joules
    s: Tensor   # () or (U,) int32 split index


def _single(env: NetworkEnv, name: str) -> None:
    if env.fleet is not None:
        raise ValueError(f"{name} takes one environment, got a fleet of {env.fleet}; "
                         "evaluate members one at a time (planning.member)")


def device_only(env: NetworkEnv, prof: ModelProfile) -> Outcome:
    _single(env, "device_only")
    prof = prof.to(env.device)
    comp = env.comp
    z = torch.sum(prof.fl)
    u = env.n_users
    T = (z / comp.c_device).expand(u).clone()
    E = (comp.xi_device * comp.c_device**2 * z).expand(u).clone()
    return Outcome(T=T, E=E, s=torch.full((), prof.n_layers, dtype=torch.int32,
                                          device=env.device))


def _greedy_vars(env: NetworkEnv, r_scale: float = 1.0) -> GdVars:
    """Max power, best own-gain subchannel, full edge allocation."""
    rc, cc = env.radio, env.comp
    best_up = torch.argmax(env.own_gain_up(), dim=-1)
    best_dn = torch.argmax(env.own_gain_dn(), dim=-1)
    m, u, dev = env.n_sub, env.n_users, env.device
    return GdVars(
        beta_up=F.one_hot(best_up, m).float(),
        beta_dn=F.one_hot(best_dn, m).float(),
        p_up=torch.full((u,), rc.p_up_max_w, device=dev),
        p_dn=torch.full((u,), rc.p_dn_max_w, device=dev),
        r=torch.full((u,), cc.r_max, device=dev) * r_scale,
    )


def edge_only(env: NetworkEnv, prof: ModelProfile) -> Outcome:
    _single(env, "edge_only")
    prof = prof.to(env.device)
    v = _greedy_vars(env)
    s = torch.zeros((), dtype=torch.int32, device=env.device)
    T, E = _delay_energy(env, prof, s, v)
    return Outcome(T=T, E=E, s=s)


def _oma_delay_energy(comp, pre, suf, w, m_dn, speed, p_up, p_dn, r_up, r_dn):
    """The OMA arms' (T, E), the reference's terms in its order."""
    T = pre / comp.c_device + suf / speed + w / r_up + m_dn / r_dn
    E = (comp.xi_device * comp.c_device**2 * pre
         + comp.xi_edge * speed**2 * suf
         + p_up * w / r_up
         + p_dn * m_dn / r_dn)
    return T, E


def _oma_outcome_per_split(env, prof, v, r_cap):
    """(T, E) per (split, user) with OMA rates; used by latency-only planners."""
    comp = env.comp
    r_up, r_dn = channel.oma_rates(env, v.p_up, v.p_dn)
    speed = torch.pow(r_cap, comp.lam_exponent) * comp.c_min_edge
    return _oma_delay_energy(comp, prof.prefix_flops()[:, None], prof.suffix_flops()[:, None],
                             prof.w[:, None], prof.m_down[:, None], speed,
                             v.p_up[None, :], v.p_dn[None, :], r_up[None, :], r_dn[None, :])


def _per_user_argmin(T, E) -> Outcome:
    s = torch.argmin(T, dim=0)                    # (U,) per-user split
    idx = s[None, :]
    return Outcome(T=T.gather(0, idx)[0], E=E.gather(0, idx)[0], s=s.to(torch.int32))


def neurosurgeon(env: NetworkEnv, prof: ModelProfile) -> Outcome:
    """Latency-optimal split per user; ignores energy and edge contention."""
    _single(env, "neurosurgeon")
    prof = prof.to(env.device)
    v = _greedy_vars(env)
    r_cap = torch.full((), env.comp.r_max, device=env.device)
    return _per_user_argmin(*_oma_outcome_per_split(env, prof, v, r_cap))


def dnn_surgery(env: NetworkEnv, prof: ModelProfile) -> Outcome:
    """Latency-only split but edge compute is shared across the cell's
    offloaders ([14] models limited edge resources)."""
    _single(env, "dnn_surgery")
    prof = prof.to(env.device)
    counts = torch.sum(env.same_cell(), dim=1).to(torch.float32)
    r_cap = torch.clamp_min(env.comp.r_max / counts, env.comp.r_min)  # (U,)
    v = _greedy_vars(env)
    return _per_user_argmin(*_oma_outcome_per_split(env, prof, v, r_cap[None, :]))


def ecc_oma(env: NetworkEnv, prof: ModelProfile, w: EccWeights,
            cfg: GdConfig = GdConfig()) -> Outcome:
    """The ECC tradeoff optimizer over OMA channels: projected plain GD on
    the normalized (p_up, p_dn, r) per split, warm-chained over splits (split
    s starts from split s-1's final point), no subchannel variable (OMA
    pre-assigns spectrum). A split stops at |Gamma_new - Gamma| <
    eps * max(1, |Gamma|) or at max_iters. As li_gd.gd_solve, the steps run
    in chunks with a device stop flag that freezes the state, and the host
    reads the flag once per chunk."""
    _single(env, "ecc_oma")
    prof = prof.to(env.device)
    comp, rc = env.comp, env.radio
    pre, suf = prof.prefix_flops(), prof.suffix_flops()

    def phys(norm):
        return (rc.p_up_min_w + norm["p_up"] * (rc.p_up_max_w - rc.p_up_min_w),
                rc.p_dn_min_w + norm["p_dn"] * (rc.p_dn_max_w - rc.p_dn_min_w),
                comp.r_min + norm["r"] * (comp.r_max - comp.r_min))

    def outcome(norm, s):
        p_up, p_dn, r = phys(norm)
        r_up, r_dn = channel.oma_rates(env, p_up, p_dn)
        speed = torch.pow(r, comp.lam_exponent) * comp.c_min_edge
        return _oma_delay_energy(comp, _at(pre, s), _at(suf, s), _at(prof.w, s),
                                 _at(prof.m_down, s), speed, p_up, p_dn, r_up, r_dn)

    def gamma_fn(norm, s):
        T, E = outcome(norm, s)
        return torch.sum(w.w_T * T + w.w_E * E)

    def value_and_grad(norm, s):
        with torch.enable_grad():
            x = {k: norm[k].detach().requires_grad_(True) for k in OMA_KEYS}
            gamma = gamma_fn(x, s)
            grads = torch.autograd.grad(gamma, [x[k] for k in OMA_KEYS])
        return gamma.detach(), dict(zip(OMA_KEYS, grads))

    def solve_one(norm, s):
        gamma = gamma_fn(norm, s)
        it = torch.zeros((), dtype=torch.int32, device=env.device)
        done = torch.zeros((), dtype=torch.bool, device=env.device)
        executed, chunk = 0, 1
        while executed < cfg.max_iters:
            n = min(chunk, cfg.max_iters - executed)
            for _ in range(n):
                g0, g = value_and_grad(norm, s)
                new = {k: torch.clamp(norm[k] - cfg.step_size * g[k], 0.0, 1.0)
                       for k in OMA_KEYS}
                g1 = gamma_fn(new, s)
                stop = torch.abs(g1 - g0) < cfg.eps * torch.clamp_min(torch.abs(g0), 1.0)
                live = ~done
                norm = {k: torch.where(live, new[k], norm[k]) for k in OMA_KEYS}
                gamma = torch.where(live, g1, gamma)
                it = it + live.to(torch.int32)
                done = done | stop
            executed += n
            COUNTS["steps"] += n
            COUNTS["host_reads"] += 1
            if bool(done):            # the one host read of this chunk
                break
            chunk = min(2 * chunk, SYNC_EVERY)
        return norm, gamma

    u = env.n_users
    carry = {k: torch.full((u,), 0.5, device=env.device) for k in OMA_KEYS}
    gammas, norms = [], []
    with torch.no_grad():
        for s in range(prof.n_layers + 1):
            carry, gamma = solve_one(carry, s)
            gammas.append(gamma)
            norms.append(carry)
        s_star = torch.argmin(torch.stack(gammas)).to(torch.int32)
        best = {k: _at(torch.stack([n[k] for n in norms]), s_star) for k in OMA_KEYS}
        T, E = outcome(best, s_star)
    return Outcome(T=T, E=E, s=s_star)


def evaluate_plan(env: NetworkEnv, prof: ModelProfile, plan, w: EccWeights) -> Outcome:
    """Evaluate a discrete SplitPlan under the true NOMA rate model."""
    _single(env, "evaluate_plan")
    prof = prof.to(env.device)
    v = GdVars(
        beta_up=F.one_hot(plan.sub_up.long(), env.n_sub).float(),
        beta_dn=F.one_hot(plan.sub_dn.long(), env.n_sub).float(),
        p_up=plan.p_up,
        p_dn=plan.p_dn,
        r=plan.r,
    )
    T, E = _delay_energy(env, prof, plan.s, v)
    return Outcome(T=T, E=E, s=plan.s)
