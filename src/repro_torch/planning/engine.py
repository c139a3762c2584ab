"""PlannerEngine: the entry point for one-shot and online warm-started ECC
planning of one scenario, or of a fleet of same-shape scenarios, on one
device.

  plan(env)          -- one-shot solve (the paper's Table I).
  plan_many(envs)    -- the same for a fleet: one batched Li-GD solve of B
                        environments, every kernel launch covering all B.
  replan(prev, env)  -- online Li-GD: every split point warm-starts from the
                        previous epoch's normalized optimum at the same split
                        and resumes its Adam moments, when one utility probe
                        says that start beats the fresh chain carry.
  replan_many(prev, envs) -- the fleet replan: the warm gate, the probes and
                        the step counts per member.

All return a PlanState: the discrete SplitPlan plus the solver state that
warm-starts the next epoch (a fleet's leaves lead with B). The warm gate -- the epoch-to-epoch channel
correlation between the stored and the observed gains, below
``warm_rho_min`` the temporal starts are disabled and the solve is the exact
cold Li-GD chain -- and the Adam-moment decay are computed on the device, so
they cost no host read. The solver's only host reads are the per-chunk stop
flags of li_gd.gd_solve.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import channel, li_gd
from repro_torch.core.types import (
    EccWeights,
    GdConfig,
    ModelProfile,
    NetworkEnv,
    SplitPlan,
    Tensor,
    make_weights,
    tree_map,
)
from repro_torch.device import resolve_device


class WarmStateShapeError(ValueError):
    """A warm-start PlanState does not fit the observed network shape (user,
    AP or subchannel count changed, or a fleet state was handed to the
    single-scenario entry point and vice versa); plan cold instead."""


@dataclasses.dataclass(frozen=True)
class PlanState:
    """A plan plus the solver state needed to warm-start the next epoch.
    Every tensor stays on the device; a fleet's lead with B."""

    plan: SplitPlan | None
    norms: dict                     # per-split normalized optima, ([B,] F+1, ...)
    total_iters: Tensor | None = None  # ([B],) GD iterations spent on this plan
    moms: tuple | None = None       # per-split Adam moments (m1, m2), ([B,] F+1, ...)
    opt_steps: Tensor | None = None  # ([B,] F+1) int32 optimizer steps behind `moms`
    gains: Tensor | None = None     # g_up of the planned epoch (rho estimation)
    warm_rho: Tensor | None = None  # ([B],) rho estimate behind the warm gate
                                    # (None when the state came from a plan)


def stack_envs(envs: Sequence[NetworkEnv]) -> NetworkEnv:
    """Stack same-shape environments along a leading fleet dim. The radio
    and compute constants stay shared, so every member must carry the same."""
    envs = list(envs)
    first = envs[0]
    for e in envs[1:]:
        if (e.radio, e.comp) != (first.radio, first.comp):
            raise ValueError("stack_envs: the members' radio/compute constants differ; "
                             "a fleet shares them")
        if tuple(e.g_up.shape) != tuple(first.g_up.shape):
            raise ValueError(f"stack_envs: member shapes differ, g_up "
                             f"{tuple(e.g_up.shape)} vs {tuple(first.g_up.shape)}")
    return NetworkEnv(g_up=torch.stack([e.g_up for e in envs]),
                      g_dn=torch.stack([e.g_dn for e in envs]),
                      ap=torch.stack([e.ap for e in envs]),
                      radio=first.radio, comp=first.comp)


def member(tree, i: int):
    """Fleet member i of a stacked NetworkEnv or a fleet PlanState. Scalar
    tensors pass through, as constants do."""
    return tree_map(lambda x: x[i] if x.ndim > 0 else x, tree)


def plan_state_template(n_users: int, n_aps: int, n_sub: int, n_splits: int, warm: bool,
                        fleet: int | None = None, device=None) -> PlanState:
    """A PlanState of zero tensors with the fields, shapes and dtypes of the
    states plan() (``warm=False``) and replan() (``warm=True``) return for
    (U, N, M) networks and F+1 = ``n_splits`` split points; a fleet's lead
    with B = ``fleet``. Built from the shapes alone (no solve), on
    ``device`` (``"meta"`` allocates nothing). Both optimizers carry the
    Adam moments and step counts (zeros under plain GD); only a warm state
    has ``warm_rho``."""
    dev = resolve_device(device)
    lead = () if fleet is None else (int(fleet),)
    u, n, m, f1 = int(n_users), int(n_aps), int(n_sub), int(n_splits)

    def z(shape, dtype=torch.float32):
        return torch.zeros(lead + tuple(shape), dtype=dtype, device=dev)

    i32 = torch.int32
    plan = SplitPlan(s=z((), i32), sub_up=z((u,), i32), sub_dn=z((u,), i32),
                     p_up=z((u,)), p_dn=z((u,)), r=z((u,)), utility=z(()),
                     per_layer_utility=z((f1,)), iters=z((f1,), i32),
                     rounding_violations=z((), i32))

    def norms():
        return {k: z((f1, u, m) if k.startswith("beta") else (f1, u)) for k in li_gd.KEYS}

    return PlanState(plan=plan, norms=norms(), total_iters=z((), i32),
                     moms=(norms(), norms()), opt_steps=z((f1,), i32), gains=z((u, n, m)),
                     warm_rho=z(()) if warm else None)


def _state(env, loop, plan, rho=None) -> PlanState:
    return PlanState(plan=plan, norms=loop.norms, total_iters=loop.total_iters,
                     moms=loop.moms, opt_steps=loop.opt_steps, gains=env.g_up,
                     warm_rho=rho)


class PlannerEngine:
    """Unified planning API for one model profile on one device.

    method: 'li_gd' (paper warm-start chain) or 'gd' (cold-start baseline).
    rounding: 'best' | 'greedy' | 'paper' (see li_gd.assemble_plan).
    warm_rho_min: replan's gate; a scenario whose estimated epoch-to-epoch
        correlation is below it runs the exact cold Li-GD chain. 0 disables
        the fallback.
    warm_moment_decay: factor applied to the carried Adam moments on resume
        (1.0 resumes verbatim, 0.0 zeroes).
    sinr_backend: 'einsum' | 'kernel' (None keeps cfg's value).
    device: None resolves to the card and raises without CUDA; pass
        device='cpu' for the plain versions on the CPU. Envs handed to the
        entry points must live on this device.
    """

    def __init__(
        self,
        prof: ModelProfile,
        weights: EccWeights | None = None,
        cfg: GdConfig = GdConfig(),
        method: str = "li_gd",
        rounding: str = "best",
        warm_rho_min: float = 0.5,
        warm_moment_decay: float = 0.1,
        sinr_backend: str | None = None,
        device=None,
    ):
        if method not in ("li_gd", "gd"):
            raise KeyError(method)
        if sinr_backend is not None:
            cfg = dataclasses.replace(cfg, sinr_backend=sinr_backend)
        if cfg.sinr_backend not in channel.SINR_BACKENDS:
            raise ValueError(
                f"sinr_backend must be one of {channel.SINR_BACKENDS}, "
                f"got {cfg.sinr_backend!r}")
        if not 0.0 <= warm_rho_min <= 1.0:
            raise ValueError(f"warm_rho_min must be in [0, 1], got {warm_rho_min}")
        if not 0.0 <= warm_moment_decay <= 1.0:
            raise ValueError(
                f"warm_moment_decay must be in [0, 1], got {warm_moment_decay}")
        self.device = resolve_device(device)
        self._prof = prof.to(self.device)
        self._weights = None if weights is None else weights.to(self.device)
        self.cfg = cfg
        self.method = method
        self.rounding = rounding
        self.warm_rho_min = warm_rho_min
        self.warm_moment_decay = warm_moment_decay

    @property
    def prof(self) -> ModelProfile:
        return self._prof

    @property
    def weights(self) -> EccWeights | None:
        return self._weights

    @property
    def sinr_backend(self) -> str:
        return self.cfg.sinr_backend

    def _check_env(self, env: NetworkEnv) -> None:
        if env.g_up.ndim != 3:
            raise ValueError(f"plan/replan take one scenario, g_up (U, N, M); got "
                             f"{tuple(env.g_up.shape)} -- use plan_many()/replan_many() "
                             "for a fleet")
        self._check_device(env)

    def _check_device(self, env: NetworkEnv) -> None:
        if env.device != self.device:
            raise ValueError(f"env is on {env.device} but the engine runs on "
                             f"{self.device}; move it with env.to(device)")

    def _prof_arg(self, prof: ModelProfile | None) -> ModelProfile:
        """The static profile, or a measured one validated against it."""
        if prof is None:
            return self._prof
        return self._prof.validate_like(prof).to(self.device)

    def _w(self, env: NetworkEnv, weights: EccWeights | None) -> EccWeights:
        if weights is not None:
            return weights.to(self.device)
        if self._weights is not None:
            return self._weights
        return make_weights(env.n_users, device=self.device)

    def _assemble(self, env, loop, prof, w) -> SplitPlan:
        return li_gd.assemble_plan(env, loop, prof, rounding=self.rounding, w=w,
                                   backend=self.cfg.sinr_backend)

    # -- entry points ----------------------------------------------------
    @torch.no_grad()
    def plan(self, env: NetworkEnv, weights: EccWeights | None = None,
             prof: ModelProfile | None = None) -> PlanState:
        """One-shot solve of a static environment. ``prof`` substitutes a
        measured profile, validated against the static one."""
        self._check_env(env)
        return self._solve(env, weights, prof)

    @torch.no_grad()
    def plan_many(self, envs: NetworkEnv | Sequence[NetworkEnv],
                  weights: EccWeights | None = None,
                  prof: ModelProfile | None = None) -> PlanState:
        """Batched solve of a fleet: ``envs`` is a list of same-shape
        environments or a NetworkEnv whose tensors lead with B. One Li-GD
        solve runs all B members, each kernel launch covering all of them.
        Returns a PlanState whose leaves lead with B."""
        envs = self._fleet(envs, "plan_many")
        if envs.g_up.ndim != 4:
            raise ValueError(
                f"plan_many expects stacked envs with g_up (B, U, N, M); got "
                f"{tuple(envs.g_up.shape)} -- use plan() for a single scenario")
        self._check_device(envs)
        return self._solve(envs, weights, prof)

    def _solve(self, env: NetworkEnv, weights, prof) -> PlanState:
        """The cold solve of plan / plan_many."""
        prof, w = self._prof_arg(prof), self._w(env, weights)
        loop = li_gd.gd_loop(env, prof, w, self.cfg, chain=(self.method == "li_gd"))
        return _state(env, loop, self._assemble(env, loop, prof, w))

    @staticmethod
    def _fleet(envs, entry: str) -> NetworkEnv:
        if isinstance(envs, NetworkEnv):
            return envs
        envs = list(envs)
        if not envs:
            raise ValueError(f"{entry} needs at least one environment")
        return stack_envs(envs)

    @staticmethod
    def _warm_dims(prev: PlanState) -> tuple[int | None, tuple[int, int]]:
        """(fleet size | None, (U, M)) read off a PlanState's norms: leaves
        are (F+1, U, M) for one scenario and (B, F+1, U, M) for a fleet."""
        beta = prev.norms["beta_up"]
        if beta.ndim == 3:
            return None, tuple(beta.shape[-2:])
        if beta.ndim == 4:
            return int(beta.shape[0]), tuple(beta.shape[-2:])
        raise WarmStateShapeError(
            f"warm-start norms have rank-{beta.ndim} leaves {tuple(beta.shape)}; "
            "expected (F+1, U, M) for a single scenario or (B, F+1, U, M) "
            "for a fleet")

    def _warm_args(self, prev: PlanState, gains: Tensor):
        """(norms, moms, steps, prev_gains) for the warm solve, on the
        device: missing moments/steps are zeros, and missing gains fall back
        to the new epoch's (rho estimate 1, gate open)."""
        norms, moms, steps = prev.norms, prev.moms, prev.opt_steps
        if moms is None:
            moms = (li_gd.zeros_like(norms), li_gd.zeros_like(norms))
        if steps is None:
            steps = torch.zeros(norms["beta_up"].shape[:-2], dtype=torch.int32,
                                device=self.device)
        prev_gains = gains if prev.gains is None else prev.gains
        return norms, moms, steps, prev_gains

    @torch.no_grad()
    def replan(self, prev: PlanState | None, env: NetworkEnv,
               weights: EccWeights | None = None,
               prof: ModelProfile | None = None) -> PlanState:
        """Online re-plan for the next epoch of a time-correlated scenario.
        Falls back to plan() without a previous state."""
        if prev is None:
            return self.plan(env, weights, prof=prof)
        self._check_env(env)
        fleet, warm_um = self._warm_dims(prev)
        if fleet is not None:
            raise WarmStateShapeError(
                f"fleet-batched PlanState (B={fleet}) passed to replan(); "
                "use replan_many() for fleets, or planning.member(state, i) "
                "to re-plan one member")
        if warm_um != (env.n_users, env.n_sub) or (
                prev.gains is not None
                and tuple(prev.gains.shape) != tuple(env.g_up.shape)):
            raise WarmStateShapeError(
                f"warm-start state is for a (U, M)={warm_um} network but the "
                f"new env has {tuple(env.g_up.shape)}; scenario shapes (users, "
                "APs, subchannels) must stay static across epochs (use plan() "
                "after a shape change)")
        return self._resolve(prev, env, weights, prof)

    @torch.no_grad()
    def replan_many(self, prev: PlanState | None,
                    envs: NetworkEnv | Sequence[NetworkEnv],
                    weights: EccWeights | None = None,
                    prof: ModelProfile | None = None) -> PlanState:
        """Fleet replan: ``prev`` is the fleet PlanState of the previous
        epoch's plan_many/replan_many, ``envs`` a stacked NetworkEnv or a
        list of same-shape environments. The warm gate, the warm-or-carry
        probes and the Adam step counts apply per member. Falls back to
        plan_many() without a previous state."""
        envs = self._fleet(envs, "replan_many")
        if envs.g_up.ndim != 4:
            raise WarmStateShapeError(
                f"replan_many expects stacked envs with g_up (B, U, N, M); "
                f"got {tuple(envs.g_up.shape)} -- use replan() for a single "
                "scenario")
        if prev is None:
            return self.plan_many(envs, weights, prof=prof)
        self._check_device(envs)
        b, u, m = envs.fleet, envs.n_users, envs.n_sub
        fleet, warm_um = self._warm_dims(prev)
        if fleet is None:
            raise WarmStateShapeError(
                f"single-scenario PlanState (norms leaves "
                f"{tuple(prev.norms['beta_up'].shape)}) passed to "
                "replan_many(); fleet states carry a leading fleet dim -- "
                "start from plan_many(), or use replan() for one scenario")
        if (fleet, *warm_um) != (b, u, m) or (
                prev.gains is not None
                and tuple(prev.gains.shape) != tuple(envs.g_up.shape)):
            raise WarmStateShapeError(
                f"warm-start state is for a fleet of {fleet} (U, M)={warm_um} "
                f"networks but the stacked envs have g_up "
                f"{tuple(envs.g_up.shape)}; fleet and scenario shapes must "
                "stay static across epochs (use plan_many() after a shape "
                "change)")
        return self._resolve(prev, envs, weights, prof)

    def _resolve(self, prev: PlanState, env: NetworkEnv, weights, prof) -> PlanState:
        """The warm solve of replan / replan_many: rho gate, moment decay,
        warm Li-GD and plan assembly, all on the device."""
        prof, w = self._prof_arg(prof), self._w(env, weights)
        norms, moms, steps, prev_gains = self._warm_args(prev, env.g_up)
        norms = {k: v.to(self.device) for k, v in norms.items()}
        rho = li_gd.rho_estimate(prev_gains.to(self.device), env.g_up)
        # rho is in [0, 1], so warm_rho_min <= 0 keeps the gate always open.
        use_warm = rho >= self.warm_rho_min
        moms = tuple({k: self.warm_moment_decay * m[k].to(self.device)
                      for k in li_gd.KEYS} for m in moms)
        loop = li_gd.gd_loop(env, prof, w, self.cfg, warm=norms, warm_mom=moms,
                             warm_steps=steps.to(self.device), use_warm=use_warm)
        return _state(env, loop, self._assemble(env, loop, prof, w), rho)
