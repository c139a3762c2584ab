"""PlannerEngine: the entry point for one-shot and online warm-started ECC
planning of one scenario on one device.

  plan(env)          -- one-shot solve (the paper's Table I).
  replan(prev, env)  -- online Li-GD: every split point warm-starts from the
                        previous epoch's normalized optimum at the same split
                        and resumes its Adam moments, when one utility probe
                        says that start beats the fresh chain carry.

Both return a PlanState: the discrete SplitPlan plus the solver state that
warm-starts the next epoch. The warm gate -- the epoch-to-epoch channel
correlation between the stored and the observed gains, below
``warm_rho_min`` the temporal starts are disabled and the solve is the exact
cold Li-GD chain -- and the Adam-moment decay are computed on the device, so
they cost no host read. The solver's only host reads are the per-chunk stop
flags of li_gd.gd_solve.
"""
from __future__ import annotations

import dataclasses

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
)
from repro_torch.device import resolve_device


class WarmStateShapeError(ValueError):
    """A warm-start PlanState does not fit the observed network shape; plan
    cold instead."""


@dataclasses.dataclass(frozen=True)
class PlanState:
    """A plan plus the solver state needed to warm-start the next epoch.
    Every tensor stays on the device."""

    plan: SplitPlan | None
    norms: dict                     # per-split normalized optima, (F+1, ...)
    total_iters: Tensor | None = None  # () GD iterations spent on this plan
    moms: tuple | None = None       # per-split Adam moments (m1, m2), (F+1, ...)
    opt_steps: Tensor | None = None  # (F+1,) int32 optimizer steps behind `moms`
    gains: Tensor | None = None     # g_up of the planned epoch (rho estimation)
    warm_rho: Tensor | None = None  # () rho estimate behind the warm gate
                                    # (None when the state came from plan())


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
        device='cpu' for the plain versions on the CPU. Envs handed to plan
        and replan must live on this device.
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
                             f"{tuple(env.g_up.shape)}")
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
        prof, w = self._prof_arg(prof), self._w(env, weights)
        loop = li_gd.gd_loop(env, prof, w, self.cfg, chain=(self.method == "li_gd"))
        return _state(env, loop, self._assemble(env, loop, prof, w))

    @staticmethod
    def _warm_um(prev: PlanState) -> tuple[int, int]:
        beta = prev.norms["beta_up"]
        if beta.ndim != 3:
            raise WarmStateShapeError(
                f"warm-start norms have rank-{beta.ndim} leaves "
                f"{tuple(beta.shape)}; expected (F+1, U, M)")
        return tuple(beta.shape[-2:])

    def _warm_args(self, prev: PlanState, gains: Tensor):
        """(norms, moms, steps, prev_gains) for the warm solve, on the
        device: missing moments/steps are zeros, and missing gains fall back
        to the new epoch's (rho estimate 1, gate open)."""
        norms, moms, steps = prev.norms, prev.moms, prev.opt_steps
        if moms is None:
            moms = (li_gd.zeros_like(norms), li_gd.zeros_like(norms))
        if steps is None:
            steps = torch.zeros(norms["beta_up"].shape[0], dtype=torch.int32,
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
        warm_um = self._warm_um(prev)
        if warm_um != (env.n_users, env.n_sub) or (
                prev.gains is not None
                and tuple(prev.gains.shape) != tuple(env.g_up.shape)):
            raise WarmStateShapeError(
                f"warm-start state is for a (U, M)={warm_um} network but the "
                f"new env has {tuple(env.g_up.shape)}; scenario shapes must "
                "stay static across epochs (use plan() after a shape change)")
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
