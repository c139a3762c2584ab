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
warm-starts the next epoch (a fleet's leaves lead with B).

The entry points share a cache of compiled programs (planning.programs),
keyed as the JAX engine keys its jitted ones: (entry kind, env shape,
GdConfig, method, rounding, warm_rho_min, warm_moment_decay). On the card a
program is a set of CUDA graphs (one GD step a split point, the plan
assembly) captured once and replayed on every later call, so a serving loop
that re-plans every epoch captures once per network shape; compile_log()
records each build. cache_size / cache_keys / program / program_args expose
the cache. The warm gate -- the epoch-to-epoch channel
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
from repro_torch.planning.programs import PlanState, Program, compile_log  # noqa: F401

# The program kinds of the cache; the JAX engine's *_sharded kinds wait for
# runtime/sharding.
KINDS = ("plan", "plan_many", "replan", "replan_many")


class WarmStateShapeError(ValueError):
    """A warm-start PlanState does not fit the observed network shape (user,
    AP or subchannel count changed, or a fleet state was handed to the
    single-scenario entry point and vice versa); plan cold instead."""


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

    cfg, method, rounding, warm_rho_min and warm_moment_decay are read at
    each call and are part of the cache key: assigning one on a live engine
    builds new programs instead of changing the ones already built. The
    programs of one engine capture and replay on one stream of its own and
    share one graph memory pool.
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
        self._cache: dict[tuple, Program] = {}
        graphed = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if graphed else None
        self._pool = torch.cuda.graph_pool_handle() if graphed else None

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

    # -- compiled-program cache ------------------------------------------
    def _compiled(self, kind: str, env: NetworkEnv) -> Program:
        # warm_rho_min / warm_moment_decay are constants of the replan
        # programs, so they belong in the key: retuning them on a live
        # engine builds new programs, not silently keeps the old gate.
        if kind not in KINDS:
            raise KeyError(kind)
        key = (kind, tuple(env.g_up.shape), self.cfg, self.method, self.rounding,
               self.warm_rho_min, self.warm_moment_decay)
        prog = self._cache.get(key)
        if prog is None:
            prog = self._cache[key] = Program(
                kind, self.cfg, self.method, self.rounding, self.warm_rho_min,
                self.warm_moment_decay, self.device, stream=self._stream, pool=self._pool)
        return prog

    def cache_size(self) -> int:
        return len(self._cache)

    def cache_keys(self) -> list[tuple]:
        """The compiled-program cache keys, for cache-discipline audits:
        (kind, env shape, GdConfig, method, rounding, warm_rho_min,
        warm_moment_decay). Read-only snapshot."""
        return list(self._cache)

    def program(self, kind: str, env: NetworkEnv) -> Program:
        """The program this engine dispatches for (kind, env), built and
        cached on first access exactly as the entry points do; call it with
        program_args(kind, env, ...)."""
        return self._compiled(kind, env)

    def program_args(self, kind: str, env: NetworkEnv, prev: PlanState | None = None,
                     weights: EccWeights | None = None,
                     prof: ModelProfile | None = None) -> tuple:
        """The positional arguments program(kind, env) is called with: (env,
        prof, w) for the plan kinds, plus the warm payload (norms, moms,
        steps, prev_gains) of ``prev`` for the replan kinds. ``env`` is one
        environment for plan / replan and a stacked fleet for the *_many
        kinds. ``prof`` substitutes a measured profile, as the entry points
        do (validated; the same program)."""
        w = self._w(env, weights)
        prof = self._prof_arg(prof)
        if kind.startswith("plan"):
            return (env, prof, w)
        if prev is None:
            raise ValueError(f"program_args({kind!r}) needs prev= (a PlanState) to "
                             "assemble the warm payload")
        return (env, prof, w, *self._warm_args(prev, env.g_up))

    # -- entry points ----------------------------------------------------
    @torch.no_grad()
    def plan(self, env: NetworkEnv, weights: EccWeights | None = None,
             prof: ModelProfile | None = None) -> PlanState:
        """One-shot solve of a static environment. ``prof`` substitutes a
        measured profile, validated against the static one."""
        self._check_env(env)
        return self._compiled("plan", env)(*self.program_args("plan", env, weights=weights,
                                                              prof=prof))

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
        return self._compiled("plan_many", envs)(
            *self.program_args("plan_many", envs, weights=weights, prof=prof))

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
        return self._compiled("replan", env)(
            *self.program_args("replan", env, prev, weights=weights, prof=prof))

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
        return self._compiled("replan_many", envs)(
            *self.program_args("replan_many", envs, prev, weights=weights, prof=prof))
