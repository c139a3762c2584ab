"""The Loop-iteration Gradient Descent (Li-GD) optimizer — paper Table I.

* The solver works in normalized coordinates: subchannel shares beta live on
  the probability simplex with a floor beta_min; powers and compute units are
  mapped to [0, 1] via their boxes.
* Gradients come from autograd of the utility.
* The per-split solve stops on the paper's rules (a gradient criterion,
  |Gamma_{k+1}-Gamma_k| < eps, or max variable change < eps), capped at
  max_iters. It runs in chunks of steps with no host read inside a chunk: a
  device flag freezes the state (torch.where) once a rule has fired, so the
  frozen steps change nothing and the iteration count equals a loop that
  stops at once. The host reads the flag once per chunk; chunks grow
  1, 2, 4, ... up to SYNC_EVERY steps, so a warm solve that stops after a
  step or two wastes little, and a long solve reads the host once per
  SYNC_EVERY steps.
* Li-GD chains split points, warm-starting split s+1 from the optimum of
  split s (Table I lines 13-16); chain=False is the cold-start baseline.
* Online warm starts resume the Adam moments and step counts.
* Fleets: every function takes a fleet env (planning.stack_envs, each
  tensor leading with B) and solves all B members at once, as jax.vmap of
  the reference does. The stop flags, iteration counts, norms, utilities
  and Adam step counts are per member, and a stopped member stays frozen
  while the others run, so its counts equal a solve of it alone. A single
  environment is solved as a fleet of one (_lift), so there is one code
  path; its results come back without the member dim (_drop).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.types import (
    EccWeights,
    GdConfig,
    GdVars,
    ModelProfile,
    NetworkEnv,
    SplitPlan,
    Tensor,
    tree_map,
)
from repro_torch.core.utility import utility as _utility

# Leaf order of the reference's pytree of normalized variables (sorted dict
# keys): tree norms are summed in this order.
KEYS = ("beta_dn", "beta_up", "p_dn", "p_up", "r")
# Longest chunk of GD steps between two host reads of the stop flag.
SYNC_EVERY = 8
# GD steps executed (frozen ones included) and host reads of the stop flag,
# since the last reset; chip_smoke.py reads them around the main path.
COUNTS = {"steps": 0, "host_reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _lift(x):
    """One environment's objects as a fleet of one."""
    return tree_map(lambda t: t.unsqueeze(0), x)


def _drop(x):
    """A fleet of one's results without the member dim."""
    return tree_map(lambda t: t[0], x)


def _bcast(c: Tensor, like: Tensor) -> Tensor:
    """A (B,) per-member tensor shaped to broadcast against a (B, ...) leaf."""
    return c.reshape(c.shape + (1,) * (like.ndim - c.ndim))


def _member_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=tuple(range(1, x.ndim)))


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------
def project_simplex(y: Tensor, total: float = 1.0) -> Tensor:
    """Euclidean projection of each row of y onto {x >= 0, sum x = total}."""
    m = y.shape[-1]
    u = torch.sort(y, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - total
    idx = torch.arange(1, m + 1, dtype=y.dtype, device=y.device)
    cond = (u - css / idx) > 0
    rho = torch.clamp_min(torch.sum(cond, dim=-1), 1)
    theta = torch.gather(css, -1, rho[..., None] - 1) / rho[..., None].to(y.dtype)
    return torch.clamp_min(y - theta, 0.0)


def project_simplex_floor(y: Tensor, floor: float) -> Tensor:
    """Projection onto {x >= floor, sum x = 1} (rows). A floor above 1/m is
    clamped to 1/m (the set is then the single point ones/m)."""
    m = y.shape[-1]
    f = torch.minimum(torch.tensor(floor, dtype=y.dtype, device=y.device),
                      torch.tensor(1.0 / m, dtype=y.dtype, device=y.device))
    z = project_simplex(y - f, total=1.0 - m * f)
    return z + f


def _project(norm: dict, beta_min: float) -> dict:
    return {
        "beta_up": project_simplex_floor(norm["beta_up"], beta_min),
        "beta_dn": project_simplex_floor(norm["beta_dn"], beta_min),
        "p_up": torch.clamp(norm["p_up"], 0.0, 1.0),
        "p_dn": torch.clamp(norm["p_dn"], 0.0, 1.0),
        "r": torch.clamp(norm["r"], 0.0, 1.0),
    }


def to_physical(norm: dict, env: NetworkEnv) -> GdVars:
    rc, cc = env.radio, env.comp
    return GdVars(
        beta_up=norm["beta_up"],
        beta_dn=norm["beta_dn"],
        p_up=rc.p_up_min_w + norm["p_up"] * (rc.p_up_max_w - rc.p_up_min_w),
        p_dn=rc.p_dn_min_w + norm["p_dn"] * (rc.p_dn_max_w - rc.p_dn_min_w),
        r=cc.r_min + norm["r"] * (cc.r_max - cc.r_min),
    )


def cold_init(env: NetworkEnv) -> dict:
    """Table I line 1: start mid-box / uniform simplex, no prior knowledge."""
    lead, u, m, dev = env.g_up.shape[:-3], env.n_users, env.n_sub, env.device
    one = torch.ones((*lead, u, m), device=dev) / m
    half = torch.full((*lead, u), 0.5, device=dev)
    return {"beta_up": one, "beta_dn": one, "p_up": half, "p_dn": half, "r": half}


def rho_estimate(prev_gains: Tensor, gains: Tensor) -> Tensor:
    """Epoch-to-epoch fading correlation rho from two gain tensors: for the
    Gauss-Markov process corr(|h_t|^2, |h_{t+1}|^2) = rho^2, so
    rho_hat = sqrt(clip(corr, 0, 1)). Computed on the device, so the warm
    gate needs no host read. Both tensors are max-normalized first (gains
    are ~1e-12), which keeps the float32 sums far from underflow. Gains are
    ([B,] U, N, M): a fleet gets one estimate per member, from that
    member's own maxima, means and sums."""
    lead = gains.shape[:-3]
    a = prev_gains.reshape(*lead, -1).float()
    b = gains.reshape(*lead, -1).float()
    a = a / torch.clamp_min(torch.amax(torch.abs(a), -1, keepdim=True), 1e-30)
    b = b / torch.clamp_min(torch.amax(torch.abs(b), -1, keepdim=True), 1e-30)
    a = a - torch.mean(a, -1, keepdim=True)
    b = b - torch.mean(b, -1, keepdim=True)
    denom = torch.sqrt(torch.sum(a * a, -1) * torch.sum(b * b, -1))
    corr = torch.sum(a * b, -1) / torch.clamp_min(denom, 1e-30)
    return torch.sqrt(torch.clamp(corr, 0.0, 1.0))


# --------------------------------------------------------------------------
# single-split-point projected GD (Table I lines 3-12)
# --------------------------------------------------------------------------
class GdResult(NamedTuple):
    norm: dict
    gamma: Tensor
    iters: Tensor     # () int32
    mom: tuple        # final Adam moments (m1, m2) -- zeros when optimizer="sgd"
    opt_steps: Tensor  # () int32 cumulative optimizer steps behind `mom`


def _tree_norm(t: dict) -> Tensor:
    """(B,): each member's norm over all leaves (summed in KEYS order)."""
    return torch.sqrt(sum(_member_sum(t[k] * t[k]) for k in KEYS))


def _tree_maxdiff(a: dict, b: dict) -> Tensor:
    """(B,): each member's largest change over all leaves."""
    return torch.amax(torch.stack([torch.amax(torch.abs(a[k] - b[k]).flatten(1), 1)
                                   for k in KEYS]), 0)


def _where(c: Tensor, a: dict, b: dict) -> dict:
    """Per member: a's leaves where c, else b's."""
    return {k: torch.where(_bcast(c, a[k]), a[k], b[k]) for k in KEYS}


def zeros_like(t: dict) -> dict:
    return {k: torch.zeros_like(t[k]) for k in KEYS}


def gd_solve(env: NetworkEnv, prof: ModelProfile, s: int, w: EccWeights,
             init_norm: dict, cfg: GdConfig, init_mom: tuple | None = None,
             init_steps: Tensor | None = None) -> GdResult:
    """Projected (Adam-)GD for one split point.

    init_mom/init_steps resume a previous solve's optimizer state: the Adam
    moments keep their history and the bias correction continues from
    init_steps instead of restarting at t=1. For a fleet env every input
    and output leads with B, and each member stops on its own."""
    if cfg.stop_rule not in ("pgd", "raw"):
        raise ValueError(f"stop_rule must be 'pgd' or 'raw', got {cfg.stop_rule!r}")
    if env.fleet is None:
        return _drop(gd_solve(_lift(env), prof, s, w, _lift(init_norm), cfg,
                              _lift(init_mom), _lift(init_steps)))
    beta_min = env.radio.beta_min
    adam = cfg.optimizer == "adam"
    dev = env.device
    steps0 = (torch.zeros(env.fleet, dtype=torch.int32, device=dev) if init_steps is None
              else init_steps.to(torch.int32))

    def gamma_fn(norm):
        return _utility(env, prof, s, to_physical(norm, env), w,
                        backend=cfg.sinr_backend)

    def value_and_grad(norm):
        # Members are independent: the gradient of the fleet's sum is each
        # member's own gradient.
        with torch.enable_grad():
            x = {k: norm[k].detach().requires_grad_(True) for k in KEYS}
            gamma = gamma_fn(x)
            grads = torch.autograd.grad(gamma.sum(), [x[k] for k in KEYS])
        return gamma.detach(), dict(zip(KEYS, grads))

    def body(norm, mom, it):
        gamma, g = value_and_grad(norm)
        if adam:
            m1, m2 = mom
            m1 = {k: cfg.adam_b1 * m1[k] + (1 - cfg.adam_b1) * g[k] for k in KEYS}
            m2 = {k: cfg.adam_b2 * m2[k] + (1 - cfg.adam_b2) * g[k] * g[k] for k in KEYS}
            t = (steps0 + it + 1).float()     # each member's own step count
            c1, c2 = 1 - cfg.adam_b1**t, 1 - cfg.adam_b2**t
            step = {k: cfg.step_size * (m1[k] / _bcast(c1, m1[k]))
                    / (torch.sqrt(m2[k] / _bcast(c2, m2[k])) + 1e-8) for k in KEYS}
            mom = (m1, m2)
        else:
            step = {k: cfg.step_size * g[k] for k in KEYS}
        new = _project({k: norm[k] - step[k] for k in KEYS}, beta_min)
        gamma_new = gamma_fn(new)
        if cfg.stop_rule == "pgd":
            # Projected-gradient residual: the raw-gradient probe step is
            # independent of the optimizer.
            probe = new if not adam else _project(
                {k: norm[k] - cfg.step_size * g[k] for k in KEYS}, beta_min)
            gcrit = _tree_norm({k: norm[k] - probe[k] for k in KEYS}) / cfg.step_size
        else:
            gcrit = _tree_norm(g)
        done = ((gcrit < cfg.eps)
                | (torch.abs(gamma_new - gamma)
                   < cfg.eps * torch.clamp_min(torch.abs(gamma), 1.0))
                | (_tree_maxdiff(new, norm) < cfg.eps))
        return new, mom, gamma_new, done

    with torch.no_grad():
        norm = _project(init_norm, beta_min)
        mom = (zeros_like(init_norm), zeros_like(init_norm)) if init_mom is None \
            else init_mom
        gamma = gamma_fn(norm)
        it = torch.zeros(env.fleet, dtype=torch.int32, device=dev)
        done = torch.zeros(env.fleet, dtype=torch.bool, device=dev)
        executed, chunk = 0, 1
        while executed < cfg.max_iters:
            n = min(chunk, cfg.max_iters - executed)
            for _ in range(n):
                new, new_mom, gamma_new, new_done = body(norm, mom, it)
                live = ~done
                norm = _where(live, new, norm)
                if adam:
                    mom = (_where(live, new_mom[0], mom[0]),
                           _where(live, new_mom[1], mom[1]))
                gamma = torch.where(live, gamma_new, gamma)
                it = it + live.to(torch.int32)
                done = done | new_done
            executed += n
            COUNTS["steps"] += n
            COUNTS["host_reads"] += 1
            if bool(done.all()):      # the one host read of this chunk
                break
            chunk = min(2 * chunk, SYNC_EVERY)
    return GdResult(norm=norm, gamma=gamma, iters=it, mom=mom, opt_steps=steps0 + it)


# --------------------------------------------------------------------------
# split-point loop (Table I), unified over warm-start policies
# --------------------------------------------------------------------------
class LoopResult(NamedTuple):
    gammas: Tensor     # (F+1,)
    iters: Tensor      # (F+1,)
    norms: dict        # stacked per-split optima, leaves lead with (F+1, ...)
    total_iters: Tensor
    moms: tuple        # stacked per-split Adam moments (m1, m2), leaves (F+1, ...)
    opt_steps: Tensor  # (F+1,) int32 cumulative optimizer steps per split
    used_warm: Tensor  # (F+1,) bool: split started from the cross-epoch state


def _stack(dicts: list[dict]) -> dict:
    """Per-split dicts of (B, ...) leaves as (B, F+1, ...) leaves."""
    return {k: torch.stack([d[k] for d in dicts], 1) for k in KEYS}


def gd_loop(env: NetworkEnv, prof: ModelProfile, w: EccWeights, cfg: GdConfig,
            *, chain: bool = True, warm: dict | None = None,
            warm_mom: tuple | None = None, warm_steps: Tensor | None = None,
            use_warm: Tensor | bool = True) -> LoopResult:
    """Solve all F+1 split points with one warm-start policy.

    For a fleet env every input leads with B (warm leaves (B, F+1, ...),
    use_warm a bool or (B,)) and so does every output.

    chain=True,  warm=None  -- paper Li-GD: split s+1 starts from split s's
                               optimum.
    chain=False, warm=None  -- plain GD: every split starts from cold_init.
    warm=stacked norms      -- online mode (leaves lead with (F+1, ...)):
                               each split starts from the better of warm[s]
                               and the chain carry, judged by one utility
                               evaluation of each on the device; warm_mom /
                               warm_steps resume the Adam state when the
                               temporal start is chosen. use_warm (a device
                               bool) False makes the solve exactly the
                               chained Li-GD.
    """
    if env.fleet is None:
        return _drop(gd_loop(_lift(env), prof, w, cfg, chain=chain, warm=_lift(warm),
                             warm_mom=_lift(warm_mom), warm_steps=_lift(warm_steps),
                             use_warm=_lift(use_warm)))
    n_splits = prof.n_layers + 1
    b, dev = env.fleet, env.device
    init = cold_init(env)
    results, picks = [], []
    if warm is not None:
        if warm_mom is None:
            warm_mom = (zeros_like(warm), zeros_like(warm))
        if warm_steps is None:
            warm_steps = torch.zeros((b, n_splits), dtype=torch.int32, device=dev)
        use_warm = torch.as_tensor(use_warm, dtype=torch.bool, device=dev)
        carry = _project(init, env.radio.beta_min)
        for s in range(n_splits):
            w0 = {k: warm[k][:, s] for k in KEYS}

            def gamma_at(n):
                return _utility(env, prof, s, to_physical(n, env), w,
                                backend=cfg.sinr_backend)

            with torch.no_grad():
                pick = use_warm & (gamma_at(w0) <= gamma_at(carry))
            start = _where(pick, w0, carry)
            mom0 = tuple({k: torch.where(_bcast(pick, m[k][:, s]), m[k][:, s], 0.0)
                          for k in KEYS} for m in warm_mom)
            steps = torch.where(pick, warm_steps[:, s], 0)
            res = gd_solve(env, prof, s, w, start, cfg, init_mom=mom0, init_steps=steps)
            carry = res.norm
            results.append(res)
            picks.append(pick)
        used_warm = torch.stack(picks, 1)
    else:
        carry = init
        for s in range(n_splits):
            res = gd_solve(env, prof, s, w, carry, cfg)
            if chain:
                carry = res.norm
            results.append(res)
        used_warm = torch.zeros((b, n_splits), dtype=torch.bool, device=dev)
    iters = torch.stack([r.iters for r in results], 1)
    return LoopResult(
        gammas=torch.stack([r.gamma for r in results], 1),
        iters=iters,
        norms=_stack([r.norm for r in results]),
        total_iters=torch.sum(iters, -1, dtype=torch.int32),   # int32, as the reference
        moms=(_stack([r.mom[0] for r in results]), _stack([r.mom[1] for r in results])),
        opt_steps=torch.stack([r.opt_steps for r in results], 1),
        used_warm=used_warm,
    )


def li_gd_loop(env: NetworkEnv, prof: ModelProfile, w: EccWeights,
               cfg: GdConfig) -> LoopResult:
    return gd_loop(env, prof, w, cfg, chain=True)


def plain_gd_loop(env: NetworkEnv, prof: ModelProfile, w: EccWeights,
                  cfg: GdConfig) -> LoopResult:
    """Cold-start GD per split point (the paper's 'traditional GD' baseline)."""
    return gd_loop(env, prof, w, cfg, chain=False)


# --------------------------------------------------------------------------
# rounding (Table I lines 17-20 + Corollary 5) and plan assembly
# --------------------------------------------------------------------------
def round_beta(beta: Tensor, paper_rule: bool = True) -> tuple[Tensor, Tensor, Tensor]:
    """Paper rule: beta > 0.5 -> 1 else 0. Returns (onehot, chosen, violations).
    Where the 0.5-rule breaks constraint (18.e) the row is repaired with
    argmax (first index at ties) and counted (per member for ([B,] U, M))."""
    if paper_rule:
        hard = (beta > 0.5).to(beta.dtype)
        viol = torch.sum(torch.abs(torch.sum(hard, dim=-1) - 1.0) > 0.5, dim=-1).to(torch.int32)
    else:
        viol = torch.zeros(beta.shape[:-2], dtype=torch.int32, device=beta.device)
    chosen = torch.argmax(beta, dim=-1).to(torch.int32)
    onehot = F.one_hot(chosen.long(), beta.shape[-1]).to(beta.dtype)
    return onehot, chosen, viol


def greedy_round_up(env: NetworkEnv, beta: Tensor, p: Tensor) -> Tensor:
    """Load-aware sequential rounding: assign users one by one to the
    subchannel maximizing their SINR given interference from the users
    already assigned. Each step gathers a (U, M) slice, never the
    (U, U, M) pairwise tensor, and keeps the chosen subchannel on the
    device (no host read per step). A fleet takes the U steps once, each
    on all members, gathering with each member's own AP ids."""
    if env.fleet is None:
        return _drop(greedy_round_up(_lift(env), beta[None], p[None]))
    own = env.own_gain_up()                          # (B, U, M)
    at_ap = env.ap.long()[:, :, None].expand(-1, -1, env.n_sub)
    assigned = torch.zeros_like(own)
    subs = []
    for u in range(env.n_users):
        sinr = p[:, u, None] * own[:, u] / (assigned[:, u] + env.noise_up)
        m = torch.argmax(beta[:, u] * torch.log1p(sinr), dim=-1)
        g_at_u = torch.gather(env.g_up[:, u], 1, at_ap)  # (B, U, M): u at every user's AP
        add = p[:, u, None, None] * g_at_u * F.one_hot(m, env.n_sub).to(own.dtype)[:, None, :]
        assigned = assigned + add
        subs.append(m)
    return torch.stack(subs, 1).to(torch.int32)


def greedy_round_dn(env: NetworkEnv, beta: Tensor, p: Tensor) -> Tensor:
    """Downlink analogue: interference at the *user* from other APs' tx."""
    if env.fleet is None:
        return _drop(greedy_round_dn(_lift(env), beta[None], p[None]))
    own = env.own_gain_dn()                          # (B, U, M)
    g_all = env.g_dn.transpose(1, 2)                 # (B, U, N, M) AP->user gains
    cell = F.one_hot(env.ap.long(), env.n_aps).to(own.dtype)   # (B, U, N)
    ap_tx = torch.zeros((env.fleet, env.n_aps, env.n_sub), dtype=own.dtype,
                        device=own.device)
    subs = []
    for u in range(env.n_users):
        # Other-AP interference via a masked sum (fp32-safe).
        interf = torch.einsum("bnm,bnm,bn->bm", ap_tx, g_all[:, u], 1.0 - cell[:, u])
        sinr = p[:, u, None] * own[:, u] / (interf + env.noise_dn)
        m = torch.argmax(beta[:, u] * torch.log1p(sinr), dim=-1)
        onehot = F.one_hot(m, env.n_sub).to(own.dtype)
        add = p[:, u, None, None] * (cell[:, u, :, None] * onehot[:, None, :])
        ap_tx = ap_tx + add
        subs.append(m)
    return torch.stack(subs, 1).to(torch.int32)


def assemble_plan(env: NetworkEnv, loop: LoopResult, prof: ModelProfile,
                  rounding: str = "best", w: EccWeights | None = None,
                  backend: str | None = None) -> SplitPlan:
    """The discrete plan at the best split: s* by argmin (first index at
    ties), its optimum picked on the device, then rounded. For a fleet each
    member takes its own s* and optimum (a gather), and the best-of
    discrete utility is each member's at its own split."""
    if env.fleet is None:
        return _drop(assemble_plan(_lift(env), _lift(loop), prof, rounding, w, backend))
    s_star = torch.argmin(loop.gammas, dim=-1).to(torch.int32)   # (B,)
    idx = s_star.long()
    members = torch.arange(env.fleet, device=idx.device)
    best = {k: loop.norms[k][members, idx] for k in KEYS}
    v = to_physical(best, env)
    _, sub_up, viol_up = round_beta(v.beta_up)
    _, sub_dn, viol_dn = round_beta(v.beta_dn)
    if rounding in ("greedy", "best"):
        g_up = greedy_round_up(env, v.beta_up, v.p_up)
        g_dn = greedy_round_dn(env, v.beta_dn, v.p_dn)
        if rounding == "greedy":
            sub_up, sub_dn = g_up, g_dn
        else:
            # best-of: the discrete utility under both roundings.
            if w is None:
                raise ValueError("rounding='best' needs the weights w")

            def disc_util(su, sd):
                vv = GdVars(
                    beta_up=F.one_hot(su.long(), env.n_sub).to(v.p_up.dtype),
                    beta_dn=F.one_hot(sd.long(), env.n_sub).to(v.p_up.dtype),
                    p_up=v.p_up, p_dn=v.p_dn, r=v.r,
                )
                return _utility(env, prof, s_star, vv, w, backend=backend)

            pick = (disc_util(g_up, g_dn) < disc_util(sub_up, sub_dn))[:, None]
            sub_up = torch.where(pick, g_up, sub_up)
            sub_dn = torch.where(pick, g_dn, sub_dn)
    return SplitPlan(
        s=s_star, sub_up=sub_up, sub_dn=sub_dn, p_up=v.p_up, p_dn=v.p_dn, r=v.r,
        utility=loop.gammas.gather(-1, idx[:, None])[:, 0],
        per_layer_utility=loop.gammas, iters=loop.iters,
        rounding_violations=viol_up + viol_dn,
    )


@torch.no_grad()
def solve(env: NetworkEnv, prof: ModelProfile, w: EccWeights,
          cfg: GdConfig = GdConfig(), method: str = "li_gd",
          rounding: str = "best") -> SplitPlan:
    if method not in ("li_gd", "gd"):
        raise KeyError(method)
    loop = gd_loop(env, prof, w, cfg, chain=(method == "li_gd"))
    return assemble_plan(env, loop, prof, rounding=rounding, w=w,
                         backend=cfg.sinr_backend)
