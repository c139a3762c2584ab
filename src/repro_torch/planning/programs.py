"""Compiled planner programs: the port's counterpart of jax.jit over the
engine's solve and resolve (src/repro/planning/engine.py, _solve_state and
_resolve_state).

PlannerEngine keeps one Program per cache key (kind, env shape, GdConfig,
method, rounding, warm_rho_min, warm_moment_decay). A Program holds:

* static device buffers for its operands (env gains and AP ids, profile,
  weights and, for a replan, the warm payload: norms, moments, step counts,
  previous gains) and for the GD state of one split (norms, moments,
  gamma, iteration counts, stop flags, starting step counts). Each call
  copies its operands in;
* on the card, one CUDA graph a split point for one GD step of
  li_gd.gd_solve, and one for the plan assembly (li_gd.assemble_plan with
  the greedy roundings, a Python loop over the users). The radio and
  compute constants are Python floats that a capture bakes in (the JAX
  package passes them as operands), so graphs are keyed by the split and
  by (env.radio, env.comp): new constants capture anew, and compile_log
  records it.

The first GD step of a split on a new key runs eagerly: it is the solve's
real first step and the warm-up (libraries load, autograd initialises).
The step is then captured from the live buffers, which executes nothing,
and every later step replays the graph, the gradient included
(torch.autograd.grad and the NOMA kernels' backward launch on the
capturing stream). The assembly is captured the same way after its first
eager run. The chunk loop stays on the host: n replays, then one read of
the stop flag. A capture or a replay that fails raises; nothing runs the
eager step in its place. On the CPU a Program runs every step eagerly on
its buffers.

Captures and replays go through repro_torch.graphs, which carries the
package's counters across replays. Graphs of one engine share one
memory pool and one stream: they replay one after another. Outputs never
alias the static buffers (the next call overwrites them): the solver's
results are fresh tensors, and the plan is cloned out of the assembly
graph's outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch import graphs
from repro_torch.core import li_gd
from repro_torch.core.types import (
    EccWeights,
    GdConfig,
    ModelProfile,
    NetworkEnv,
    SplitPlan,
    Tensor,
    tree_flatten,
    tree_map,
    tree_unflatten,
)


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


# -- compile observability -----------------------------------------------------
_COMPILE_LOGS: list[list[str]] = []


@contextlib.contextmanager
def compile_log():
    """Record the kind of every engine program that builds inside the block:

        with compile_log() as log:
            eng.plan(env); eng.replan(state, env)
        assert log == ["plan", "replan"]

    A program records once, when it first builds its graphs for a set of
    env constants (on the CPU, at its first run), so a steady-state loop
    that appends nothing proves that nothing was captured. Nesting is fine:
    each block gets its own list."""
    sink: list[str] = []
    _COMPILE_LOGS.append(sink)
    try:
        yield sink
    finally:
        _COMPILE_LOGS.remove(sink)


def record(kind: str) -> None:
    for sink in _COMPILE_LOGS:
        sink.append(kind)


# -- the program bodies ----------------------------------------------------------
def solve_state(env: NetworkEnv, prof: ModelProfile, w: EccWeights, cfg: GdConfig,
                method: str, rounding: str, runner=None) -> PlanState:
    """The cold solve of plan / plan_many. ``runner`` is the Program that
    runs it (None: eagerly, as li_gd.gd_loop + assemble_plan)."""
    loop = li_gd.gd_loop(env, prof, w, cfg, chain=(method == "li_gd"), runner=runner)
    assemble = li_gd.assemble_plan if runner is None else runner.assemble
    plan = assemble(env, loop, prof, rounding=rounding, w=w, backend=cfg.sinr_backend)
    return PlanState(plan=plan, norms=loop.norms, total_iters=loop.total_iters,
                     moms=loop.moms, opt_steps=loop.opt_steps, gains=env.g_up)


def resolve_state(env: NetworkEnv, prof: ModelProfile, w: EccWeights, warm: dict,
                  warm_mom: tuple, warm_steps: Tensor, prev_gains: Tensor, cfg: GdConfig,
                  rounding: str, warm_rho_min: float, warm_moment_decay: float,
                  runner=None) -> PlanState:
    """The warm solve of replan / replan_many: rho gate, moment decay, warm
    Li-GD and plan assembly, all on the device. ``runner`` as in
    solve_state."""
    rho = li_gd.rho_estimate(prev_gains, env.g_up)
    # rho is in [0, 1], so warm_rho_min <= 0 keeps the gate always open.
    use_warm = rho >= warm_rho_min
    warm_mom = tuple({k: warm_moment_decay * m[k] for k in li_gd.KEYS} for m in warm_mom)
    loop = li_gd.gd_loop(env, prof, w, cfg, warm=warm, warm_mom=warm_mom,
                         warm_steps=warm_steps, use_warm=use_warm, runner=runner)
    assemble = li_gd.assemble_plan if runner is None else runner.assemble
    plan = assemble(env, loop, prof, rounding=rounding, w=w, backend=cfg.sinr_backend)
    return PlanState(plan=plan, norms=loop.norms, total_iters=loop.total_iters,
                     moms=loop.moms, opt_steps=loop.opt_steps, gains=env.g_up,
                     warm_rho=rho)


class Program:
    """One key of a PlannerEngine's cache; called with program_args(kind,
    env, ...), it returns the PlanState the entry point returns. ``stream``
    and ``pool`` (the engine's, on the card) are where its graphs capture
    and replay; None on the CPU."""

    def __init__(self, kind: str, cfg: GdConfig, method: str, rounding: str,
                 warm_rho_min: float, warm_moment_decay: float, device: torch.device,
                 stream=None, pool=None):
        self.kind, self.cfg, self.method, self.rounding = kind, cfg, method, rounding
        self.warm_rho_min, self.warm_moment_decay = warm_rho_min, warm_moment_decay
        self.device = device
        self._graphed = device.type == "cuda"
        self._stream, self._pool = stream, pool
        self._operands = None      # (treedef, static buffers) of the call's operands
        self._state = None         # (treedef, static buffers) of one split's GD state
        self._live = None          # the static GD state as a tree
        self._loop = None          # static (gammas, iters, norms) read by the assembly
        self._graphs: dict[tuple, graphs.Graph] = {}   # (split | "assembly", radio, comp)
        self._built: set = set()   # the (radio, comp) this program has built for
        self._consts = None        # (radio, comp) of the running call
        self._at = None            # (split, radio, comp) of the running step
        self.capture_s = 0.0       # host seconds spent capturing

    @property
    def graph_count(self) -> int:
        return len(self._graphs)

    @torch.no_grad()
    def __call__(self, env: NetworkEnv, prof: ModelProfile, w: EccWeights,
                 *warm) -> PlanState:
        consts = (env.radio, env.comp)
        if consts not in self._built:
            self._built.add(consts)
            record(self.kind)
        if not self._graphed:
            return self._run(consts, env, prof, w, warm)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            out = self._run(consts, env, prof, w, warm)
        caller.wait_stream(self._stream)
        # The results were made on the program's stream and are used on the
        # caller's: their memory is not reused before the caller's work on
        # them is done.
        for t in tree_flatten(out)[0]:
            t.record_stream(caller)
        return out

    def _run(self, consts, env, prof, w, warm) -> PlanState:
        self._consts = consts
        s_env, s_prof, s_w, s_warm = self._load(env, prof, w, warm)
        if warm:
            out = resolve_state(s_env, s_prof, s_w, *s_warm, self.cfg, self.rounding,
                                self.warm_rho_min, self.warm_moment_decay, runner=self)
        else:
            out = solve_state(s_env, s_prof, s_w, self.cfg, self.method, self.rounding,
                              runner=self)
        # The planned epoch's gains are the caller's, not the static copy.
        return dataclasses.replace(out, gains=env.g_up)

    def _load(self, env, prof, w, warm):
        """Copy the call's operands into the static buffers (made at the
        first call) and return them as (env, prof, w, warm)."""
        ops = (env.g_up, env.g_dn, env.ap, prof.fl, prof.w, prof.m_down, w.w_T, w.w_E,
               tuple(warm))
        leaves, treedef = tree_flatten(ops)
        if self._operands is None:
            self._operands = (treedef, [graphs.static_like(x, self.device) for x in leaves])
        want, bufs = self._operands
        if treedef != want:
            raise ValueError(f"operands {treedef} do not fit the program's {want}")
        graphs.check_like(bufs, leaves, "operand")
        for b, x in zip(bufs, leaves):
            b.copy_(x)
        g_up, g_dn, ap, fl, pw, m_down, w_T, w_E, s_warm = tree_unflatten(want, bufs)
        return (dataclasses.replace(env, g_up=g_up, g_dn=g_dn, ap=ap),
                dataclasses.replace(prof, fl=fl, w=pw, m_down=m_down),
                EccWeights(w_T=w_T, w_E=w_E), s_warm)

    # -- the runner li_gd.gd_solve drives ---------------------------------------
    def enter(self, s: int, st: dict) -> dict:
        """Load split s's starting GD state into the static buffers and
        return them as the state tree the steps advance."""
        leaves, treedef = tree_flatten(st)
        if self._state is None:
            self._state = (treedef, [graphs.static_like(x, self.device) for x in leaves])
            self._live = tree_unflatten(treedef, self._state[1])
        if treedef != self._state[0]:
            raise ValueError(f"GD state {treedef} does not fit the program's {self._state[0]}")
        graphs.check_like(self._state[1], leaves, "GD state leaf")
        for b, x in zip(self._state[1], leaves):
            b.copy_(x)
        self._at = (s, *self._consts)
        return self._live

    def _write(self, new: dict) -> None:
        for b, x in zip(self._state[1], tree_flatten(new)[0]):
            if x is not b:
                b.copy_(x)

    def advance(self, step, n: int) -> None:
        """n GD steps of the static state: replays of the split's graph, or,
        on a new key, the first step eagerly and then its capture."""
        for _ in range(n):
            graph = self._graphs.get(self._at)
            if graph is not None:
                graph.replay()
                continue
            self._write(step(self._live))
            if self._graphed:
                self._graphs[self._at] = self._capture(lambda: self._write(step(self._live)))

    def assemble(self, env, loop, prof, rounding, w, backend) -> SplitPlan:
        """li_gd.assemble_plan of the static env and the loop's results: on
        the card a replay of the assembly graph over static copies of the
        results it reads, cloned out (the plan passes the per-split
        utilities and iterations through); its first run on a key eagerly
        on the results themselves, then captured."""
        if not self._graphed:
            return li_gd.assemble_plan(env, loop, prof, rounding=rounding, w=w,
                                       backend=backend)
        fields = (loop.gammas, loop.iters, loop.norms)
        if self._loop is None:
            self._loop = tree_map(lambda x: graphs.static_like(x, self.device), fields)
        for b, x in zip(tree_flatten(self._loop)[0], tree_flatten(fields)[0]):
            b.copy_(x)
        gammas, iters, norms = self._loop
        # Only what the assembly reads; the rest stays out of the graph.
        static = li_gd.LoopResult(gammas=gammas, iters=iters, norms=norms, total_iters=None,
                                  moms=None, opt_steps=None, used_warm=None)
        key = ("assembly", *self._consts)
        graph = self._graphs.get(key)
        if graph is None:
            plan = li_gd.assemble_plan(env, loop, prof, rounding=rounding, w=w,
                                       backend=backend)
            self._graphs[key] = self._capture(lambda: li_gd.assemble_plan(
                env, static, prof, rounding=rounding, w=w, backend=backend))
            return plan
        graph.replay()
        return tree_map(torch.clone, graph.out)

    def _capture(self, fn) -> graphs.Graph:
        """Capture fn on the program's stream into the engine's pool."""
        graph, secs = graphs.capture(fn, self._pool)
        self.capture_s += secs
        return graph
