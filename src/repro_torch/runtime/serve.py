"""ECC split-serve: the paper's deployment shape.

The model is cut at the ECC-planned layer s*: layers [0, s) run on the
*device*, layers [s, F) on the *edge*. The two halves are separate programs
(the paper's device and edge are distinct systems joined by a NOMA radio
link); the planner prices the activation transfer with the NOMA rate model
and `transfer_seconds` reports the simulated link time. Both halves run the
same kernels on the same shapes in the same order as Model.forward, so the
split logits equal the unsplit ones to the bit.

OnlineSplitServer couples a PlannerEngine to split serving across a
time-evolving scenario: it re-plans every epoch (or on demand) and re-cuts
the model only when s* moves.

jit_prefill, jit_decode_step and jit_masked_decode_step are the compiled
serve steps (repro_torch.graphs.Compiled): on the card each captures a CUDA
graph on its first call for a shape and replays it after; on the CPU it
runs eagerly on its static buffers. The decode steps write each step's
ring slot and states into their caches in place: the caches a step is
first given become its buffers (consumed, as the reference's donated
caches are), and the caches it returns are those buffers, which the next
step takes without a copy. ``mesh`` stands for the reference's device
mesh: None or one device (the model's), or a torch.distributed DeviceMesh
("data", "model"; launch.mesh.make_mesh) on which the model was built
(Model(cfg, mesh=mesh), every family). On a mesh each rank calls the step
on its shard of each operand, as the reference's in_shardings place them:
its rows of the tokens and of the frontend (the batch split over ("pod",
"data")), its shard of the caches (cache_shardings), the whole ``active``
mask; it gets back its rows'
logits, whole over the vocab, and its caches' shard. The layers issue the
model axis's collectives (models/tp.py), inside the CUDA graph on the
card. jit_prefill_into is online.batcher.DecodeBatcher's admission: the
prefill written straight into a slot of live caches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import graphs
from repro_torch.faults import guards
from repro_torch.models import Model
from repro_torch.models.layers import COMPUTE_DTYPE, embed_lookup, logits_out
from repro_torch.planning import WarmStateShapeError
from repro_torch.pshard import axis_size

# Host reads of the plan word (one a replan) since the last reset_counts().
COUNTS = {"host_reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class SplitPrograms(NamedTuple):
    device_fn: Callable   # tokens (B, S)[, frontend] -> activation (B, S, D) bf16
    edge_fn: Callable     # activation (B, S, D)[, frontend] -> logits float32 (B, S, Vp)
    split_layer: int
    act_bytes_per_token: int


def _split_params(model: Model, s: int):
    """The stages of layers [0, s) and of [s, F): (spec, layers) pairs, a
    stage that straddles s cut into two with its ModuleList sliced."""
    a_stages, b_stages = [], []
    seen = 0
    for spec, layers in zip(model.stages, model.stage_layers):
        if seen + spec.n_layers <= s:
            a_stages.append((spec, layers))
        elif seen >= s:
            b_stages.append((spec, layers))
        else:
            cut = s - seen
            a_stages.append((dataclasses.replace(spec, n_layers=cut), layers[:cut]))
            b_stages.append((dataclasses.replace(spec, n_layers=spec.n_layers - cut),
                             layers[cut:]))
        seen += spec.n_layers
    return a_stages, b_stages


def make_split_serve(model: Model, s: int) -> SplitPrograms:
    """Device and edge programs for split point s, a global block index in
    [0, number of blocks].

    Both halves run their blocks over the token stream as the JAX package's
    do: for whisper (audio) the encoder stage's blocks run over the token
    embeddings with no position table, and the decoder's cross attention
    reads ``frontend`` itself, not an encoder output. A cross attention
    given no frontend attends over its own input, rotated and unmasked."""
    n_blocks = sum(spec.n_layers for spec in model.stages)
    if not 0 <= s <= n_blocks:
        raise ValueError(f"split point {s} outside [0, {n_blocks}]")
    a_stages, b_stages = _split_params(model, s)

    def frontend_aux(b, sl, frontend):
        return model.aux(model._positions(b, sl),
                         None if frontend is None else frontend.to(COMPUTE_DTYPE))

    @torch.no_grad()
    def device_fn(tokens, frontend=None):
        b, sl = tokens.shape
        x = embed_lookup(model.top.embed, tokens, model.cfg.vocab_size)
        aux = frontend_aux(b, sl, frontend)
        for spec, layers in a_stages:
            x, _, _ = model._run_stage(spec, layers, x, aux, None)
        return x.to(COMPUTE_DTYPE)

    @torch.no_grad()
    def edge_fn(x, frontend=None):
        b, sl, _ = x.shape
        aux = frontend_aux(b, sl, frontend)
        for spec, layers in b_stages:
            x, _, _ = model._run_stage(spec, layers, x, aux, None)
        x = model._final_norm(x)
        return logits_out(x, model.top.unembed, model.cfg.vocab_size)

    act_bytes = model.cfg.d_model * 2  # bf16 residual stream per token
    return SplitPrograms(device_fn=device_fn, edge_fn=edge_fn, split_layer=s,
                         act_bytes_per_token=act_bytes)


# --------------------------------------------------------------------------
# compiled serve steps
# --------------------------------------------------------------------------
def _is_mesh(mesh) -> bool:
    """A DeviceMesh, or an {axis: size} mapping standing for one."""
    return hasattr(mesh, "mesh_dim_names") or isinstance(mesh, dict)


def _placement(model: Model, mesh) -> torch.device:
    """The device that stands for ``mesh``: None, a device (or its name)
    that is the model's, a sequence of one such, or the DeviceMesh the model
    was built on (any family, a model axis of any size: models/tp.py). A
    list of several devices is not a mesh: build a DeviceMesh and the model
    on it."""
    if _is_mesh(mesh):
        if model.mesh is not mesh:
            raise ValueError("the model was not built on this mesh: Model(cfg, mesh=mesh)")
        return model.device
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise NotImplementedError(
                f"a list of {len(mesh)} devices is not a mesh: serve on a DeviceMesh with a "
                "model axis (the sharding item's tensor-parallel serve layouts; "
                "launch.mesh.make_mesh and Model(cfg, mesh=mesh)), or pass None or the "
                "model's one device")
        mesh = mesh[0]
    if mesh is not None and torch.device(mesh) != model.device and not (
            torch.device(mesh).type == model.device.type and torch.device(mesh).index is None):
        raise ValueError(f"mesh {mesh} is not the model's device {model.device}")
    return model.device


def _no_params(params) -> None:
    if params is not None:
        raise ValueError("the port's Model holds its own weights: pass params=None")


def jit_prefill(model: Model, mesh, max_len: int):
    """The compiled prefill: returns (step, placement) where step(params,
    batch) -> (last-position logits (B, Vp), fresh caches of max_len), as
    Model.prefill, and placement is the device its weights live on.
    ``params`` must be None (the Model holds its weights); ``batch`` holds
    "tokens" (B, S) and optionally "frontend". One graph per (tokens shape,
    frontend shape or None): a new shape captures anew, as JAX retraces."""
    dev = _placement(model, mesh)
    prog = graphs.Compiled("prefill", lambda b: model.prefill(b, max_len), dev)

    def step(params, batch):
        _no_params(params)
        return prog({k: v for k, v in batch.items() if v is not None})

    step.program = prog
    return step, dev


def jit_prefill_into(model: Model, mesh, max_len: int):
    """The compiled admission of a slot-batched server: returns (step,
    placement) where step(params, caches, slot, batch) prefills ``batch``
    (one request: "tokens" (1, S)) as jit_prefill does, writes its caches
    into slot ``slot`` (an int) of ``caches`` in place (slot_update) in
    the same graph, and returns the last-position logits (1, Vp). The
    caches are adopted as the program's buffers (graphs.Compiled), so a
    masked decode step that holds the same caches shares them, and nothing
    is copied in or out; the request's own fresh caches are an
    intermediate of the graph. One graph per prompt length."""
    from repro_torch.online.batcher import _map_caches  # deferred: avoid the cycle
    dev = _placement(model, mesh)
    if _is_mesh(mesh) and axis_size(mesh, ("pod", "data")) > 1:
        raise NotImplementedError("admission into a slot of caches whose batch is split over "
                                  "(pod, data) waits for the batcher on a mesh; use a mesh "
                                  "whose batch axes are 1")

    def body(ops):
        logits, one = model.prefill(ops["batch"], max_len)
        _map_caches(lambda buf, x, ax: buf.index_copy_(ax, ops["slot"], x), ops["caches"],
                    one)
        return logits

    prog = graphs.Compiled("prefill", body, dev, adopt=("caches",))

    def step(params, caches, slot, batch):
        _no_params(params)
        # the slot reaches the graph as a device operand made by a fill
        at = torch.full((1,), int(slot), dtype=torch.int64, device=dev)
        return prog({"caches": caches, "slot": at,
                     "batch": {k: v for k, v in batch.items() if v is not None}})

    step.program = prog
    return step, dev


def _write_caches(static: dict, new: dict, active=None) -> None:
    """Write a decode step's new caches into the program's static caches:
    leaves that are already their buffer (written in place) are left
    alone, the others are copied, inactive slots kept when ``active`` is
    given (stage leaves (L, B, ...) select on axis 1, the rest on 0)."""
    from repro_torch.online.batcher import _map_caches  # deferred: avoid the cycle

    def write(buf, x, ax):
        if x is buf:
            return None
        if active is not None:
            shape = [1] * x.ndim
            shape[ax] = active.shape[0]
            x = torch.where(active.reshape(shape), x, buf)
        buf.copy_(x)
        return None
    _map_caches(write, static, new)


def jit_decode_step(model: Model, mesh, batch: int, max_len: int):
    """The compiled decode step: returns (step, placement, cache
    placement); step(params, caches, token (B, 1)) -> (logits (B, Vp),
    caches). The caches of its first call become its buffers, which it
    writes in place and returns: the caches it is given are consumed (as a
    donated buffer). Passing back what the last step returned (the steady
    state) copies nothing; other caches are copied into the buffers.
    ``params`` must be None."""
    dev = _placement(model, mesh)

    def body(ops):
        logits, new = model.decode_step(ops["caches"], ops["token"], in_place=True,
                                        max_len=max_len)
        _write_caches(ops["caches"], new)
        return logits

    return _decode_program("decode_step", body, model, batch, max_len, dev, masked=False)


def jit_masked_decode_step(model: Model, mesh, batch: int, max_len: int):
    """Slot-masked decode step for continuous batching: like
    jit_decode_step, but step(params, caches, token, active (B,) bool)
    feeds inactive slots token 0 and keeps their caches (pos included), so
    a slot can idle between requests and be overwritten at its next
    admission; their logits lanes are garbage by contract. Returns (step,
    placement, cache placement)."""
    dev = _placement(model, mesh)

    def body(ops):
        active = ops["active"]          # the whole batch's mask; on a mesh, this rank's
        rows = model.local_rows(active)   # rows of it for its rows of the batch
        token = torch.where(rows[:, None], ops["token"], torch.zeros_like(ops["token"]))
        logits, new = model.decode_step(ops["caches"], token, in_place=True, active=active,
                                        max_len=max_len)
        _write_caches(ops["caches"], new, rows)
        return logits

    return _decode_program("masked_decode_step", body, model, batch, max_len, dev, masked=True)


def _decode_program(kind: str, body, model: Model, batch: int, max_len: int,
                    dev: torch.device, masked: bool):
    prog = graphs.Compiled(kind, body, dev, adopt=("caches",))
    args = "(params, caches, token, active)" if masked else "(params, caches, token)"

    def step(params, caches, token, *active):
        _no_params(params)
        if len(active) != int(masked):
            raise TypeError(f"{kind} takes {args}")
        ops = {"caches": caches, "token": token}
        if masked:
            ops["active"] = active[0]
        logits = prog(ops)
        return logits, prog.operands["caches"]

    step.program = prog
    return step, dev, dev


def transfer_seconds(n_tokens: int, d_model: int, rate_bps: float) -> float:
    """Simulated NOMA uplink time for the split activation."""
    bits = n_tokens * d_model * 16
    return bits / max(rate_bps, 1e-9)


def planned_transfer_seconds(env, prof, plan):
    """Per-user split-upload seconds under the *discrete* plan: the NOMA
    uplink rate each user gets on its assigned subchannel at its planned
    power, pricing prof.w[s] bits. The planner-side twin of
    `transfer_seconds`: for an LM profile built at batch=1, w[s] = seq *
    d_model * ACT_BITS, so the two agree on the same rate."""
    from repro_torch.core import channel
    beta_up = F.one_hot(plan.sub_up.long(), env.n_sub).to(env.g_up.dtype)
    r_up = torch.sum(channel.uplink_rates(env, beta_up, plan.p_up), dim=-1)
    bits = prof.w[plan.s]
    return bits / torch.clamp_min(r_up, 1e-9)


# --------------------------------------------------------------------------
# online split-serve: re-plan as the scenario evolves, re-cut when s* moves
# --------------------------------------------------------------------------
class OnlineSplitServer:
    """Couples a PlannerEngine to split serving across a time-evolving
    scenario.

    Every ``replan_every`` epochs the engine warm-start re-plans against the
    newly observed NetworkEnv; the re-cut (make_split_serve) happens only
    when the planned split layer moves. ``observe(env)`` returns the current
    SplitPrograms.

    The epoch loop stays on the device: the engine's replan keeps its rho
    gate and warm payload on the device, GD-iteration accounting
    accumulates in a device scalar (read it through ``total_iters``), and
    the one host read a replan is the planned split layer s*, packed with
    the plan's health (faults.guards.plan_word): whether to re-cut the
    model is a host decision.

    ``model`` is the port's Model, an nn.Module that holds its own weights;
    ``params`` stays in the signature in the reference's position and must
    be None. With model None (planning-only runs) the re-cut is recorded
    but no programs are built.

    The PlanState carried across epochs holds the whole warm-start payload
    (normalized optima, Adam moments and step counts, the epoch's gains for
    the rho gate). A network shape change (user or subchannel count)
    invalidates it: observe() catches the engine's WarmStateShapeError,
    drops the warm state and plans cold; ``cold_resets`` counts these.

    With ``guard_plans=True`` (the default) the same one-scalar read also
    traps non-finite or infeasible plans: a bad plan is rejected and the
    last good PlanState held (``bad_plans`` counts these). A NaN measured
    profile otherwise flows through replan into a served plan: the utility
    goes NaN while the powers can stay finite, so the guard checks the
    whole plan.
    """

    def __init__(self, engine, model: Model | None = None, params=None,
                 replan_every: int = 1, guard_plans: bool = True):
        if replan_every < 1:
            raise ValueError(f"replan_every must be >= 1, got {replan_every}")
        if params is not None:
            raise ValueError("the port's Model holds its own weights: pass params=None")
        self.engine = engine
        self.model = model
        self.replan_every = replan_every
        self.guard_plans = bool(guard_plans)
        self.state = None               # planning.PlanState of the last good re-plan
        self.programs: SplitPrograms | None = None
        self.split_layer: int | None = None
        self.epoch = 0
        self.recuts = 0
        self.cold_resets = 0
        self.replans = 0                # scheduled + forced engine dispatches
        self.forced_replans = 0         # the off-schedule (force=True) subset
        self.bad_plans = 0              # guarded replans rejected (held last good)
        self.last_plan_ok: bool | None = None   # outcome of the last dispatch
        self.last_replanned = False     # did the last observe() dispatch?
        self._iters_acc = torch.zeros((), dtype=torch.int32, device=engine.device)

    @property
    def total_iters(self) -> int:
        """Total GD iterations across all re-plans. Reading it reads the
        device accumulator; the serving loop itself never does."""
        return int(self._iters_acc)

    def metrics(self) -> dict:
        """Counters of the server's control plane: epochs seen, replans
        dispatched (and how many were forced off-schedule), re-cuts of the
        served model, cold resets after network shape changes, rejected
        plans and total GD iterations (this read syncs the accumulator)."""
        return {
            "epoch": self.epoch,
            "replans": self.replans,
            "forced_replans": self.forced_replans,
            "recuts": self.recuts,
            "cold_resets": self.cold_resets,
            "bad_plans": self.bad_plans,
            "split_layer": self.split_layer,
            "total_iters": self.total_iters,
        }

    def export_host(self) -> dict:
        """The server's host-side control-plane state as JSON scalars. The
        device-resident pieces (the PlanState and the GD-iteration
        accumulator) travel separately."""
        return {
            "epoch": self.epoch,
            "recuts": self.recuts,
            "cold_resets": self.cold_resets,
            "replans": self.replans,
            "forced_replans": self.forced_replans,
            "bad_plans": self.bad_plans,
            "split_layer": self.split_layer,
            "last_plan_ok": self.last_plan_ok,
            "last_replanned": self.last_replanned,
        }

    def import_host(self, state: dict, iters_acc) -> None:
        """Inverse of export_host. ``iters_acc`` is the restored device
        scalar. With a model attached, the programs are re-cut at the
        restored split layer (they are functions of (model, s) alone)."""
        self.epoch = int(state["epoch"])
        self.recuts = int(state["recuts"])
        self.cold_resets = int(state["cold_resets"])
        self.replans = int(state["replans"])
        self.forced_replans = int(state["forced_replans"])
        self.bad_plans = int(state["bad_plans"])
        sl = state["split_layer"]
        self.split_layer = None if sl is None else int(sl)
        ok = state["last_plan_ok"]
        self.last_plan_ok = None if ok is None else bool(ok)
        self.last_replanned = bool(state["last_replanned"])
        self._iters_acc = torch.as_tensor(iters_acc, dtype=torch.int32,
                                          device=self.engine.device)
        if self.model is not None and self.split_layer is not None:
            self.programs = make_split_serve(self.model, self.split_layer)

    def reset_warm(self) -> None:
        """Drop the warm-start payload: the next replan goes cold (after a
        run of rejected plans the carried optima are themselves suspect)."""
        self.state = None

    def _sync_plan(self, env, plan) -> tuple[int, int]:
        """The one host read a replan: (health, s). A guarded server packs
        both into one scalar on the device (faults.guards.plan_word)."""
        COUNTS["host_reads"] += 1
        if not self.guard_plans:
            return 0, int(plan.s)
        word = guards.plan_word(plan, n_sub=env.n_sub, p_up_max=env.radio.p_up_max_w,
                                p_dn_max=env.radio.p_dn_max_w, r_max=env.comp.r_max)
        return guards.split_plan_word(int(word))

    def observe(self, env, prof=None, force: bool = False,
                hold: bool = False) -> SplitPrograms | None:
        """Advance one epoch: re-plan on schedule (or at once when ``force``
        is set), re-cut if s* moved. ``prof`` substitutes a measured profile
        (validated against the engine's static one; None plans against the
        static profile). ``hold`` skips the replan while still advancing
        the epoch clock."""
        self.last_replanned = False
        if not hold and (force or self.epoch % self.replan_every == 0):
            prev_state = self.state
            try:
                new_state = self.engine.replan(self.state, env, prof=prof)
            except WarmStateShapeError:
                # The warm-start state no longer fits this network: drop it
                # and plan cold. Other ValueErrors propagate, so a bad
                # profile is never swallowed.
                prev_state = self.state = None
                self.cold_resets += 1
                new_state = self.engine.plan(env, prof=prof)
            self.replans += 1
            self.last_replanned = True
            self.forced_replans += int(force and self.epoch % self.replan_every != 0)
            self._iters_acc = self._iters_acc + new_state.total_iters
            health, s = self._sync_plan(env, new_state.plan)
            if health:
                # Never serve a corrupt plan: keep the last good state (warm
                # payload included).
                self.bad_plans += 1
                self.last_plan_ok = False
                self.state = prev_state
            else:
                self.last_plan_ok = True
                self.state = new_state
                if s != self.split_layer:
                    self.split_layer = s
                    self.recuts += 1
                    if self.model is not None:
                        self.programs = make_split_serve(self.model, s)
        self.epoch += 1
        return self.programs
