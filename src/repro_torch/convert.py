"""State carried across from the JAX reference.

Turns the reference's objects, given as numpy arrays plus constants, into
the port's: a NetworkEnv, a ModelProfile, EccWeights, a SplitPlan, a
PlanState (one scenario's or a fleet's), a ScenarioState, and the online
loop's StreamState, BatchState, QosState, TelemetryState and FaultState,
a whole serving snapshot (serving_state_from_numpy), the served LM's
parameters (model_params_from_numpy) and its caches (caches_from_numpy),
a training state (train_state_from_numpy),
so a plan made by the reference can warm-start the port's replan /
replan_many, a reference scenario can be stepped on by the port, and a
reference episode stopped (or snapshotted) at epoch k can go on in the
port. Constants may be any object with the fields of RadioConstants /
ComputeConstants (the reference's dataclasses qualify) or a dict. No JAX here: callers convert
their arrays with np.asarray first. to_numpy goes the other way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.types import (
    ComputeConstants,
    EccWeights,
    ModelProfile,
    NetworkEnv,
    RadioConstants,
    SplitPlan,
    tree_flatten,
    tree_unflatten,
)
from repro_torch.device import resolve_device
from repro_torch.faults.injectors import FaultRates, FaultState
from repro_torch.online.batcher import BatchState
from repro_torch.online.loop import OnlineLoop
from repro_torch.online.qos import QosState
from repro_torch.online.streams import StreamState
from repro_torch.online.telemetry import TelemetryState
from repro_torch.planning.engine import PlanState
from repro_torch.scenarios.mobility import MobilityState
from repro_torch.scenarios.scenario import ScenarioState

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float32,
           np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int32,
           np.dtype(np.bool_): torch.bool, np.dtype(np.complex64): torch.complex64}


def tensor(x, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``: floats become
    float32, integers int32 and complex64 stays so, the reference's dtypes."""
    a = np.array(x)     # a writable copy: arrays from JAX are read-only
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(device=resolve_device(device),
                                  dtype=_DTYPES[a.dtype])


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, device) for v in x)
    return None if x is None else tensor(x, device)


def constants(cls, src):
    """``cls`` (RadioConstants or ComputeConstants) from None (defaults), a
    dict, or any object carrying the same field names."""
    if src is None:
        return cls()
    if isinstance(src, dict):
        return cls(**src)
    return cls(**{f.name: float(getattr(src, f.name)) for f in dataclasses.fields(cls)})


def env_from_numpy(g_up, g_dn, ap, radio=None, comp=None, device=None) -> NetworkEnv:
    return NetworkEnv(g_up=tensor(g_up, device), g_dn=tensor(g_dn, device),
                      ap=tensor(ap, device),
                      radio=constants(RadioConstants, radio),
                      comp=constants(ComputeConstants, comp))


def profile_from_numpy(fl, w, m_down, name: str = "model", device=None) -> ModelProfile:
    return ModelProfile(fl=tensor(fl, device), w=tensor(w, device),
                        m_down=tensor(m_down, device), name=name)


def weights_from_numpy(w_T, w_E, device=None) -> EccWeights:
    return EccWeights(w_T=tensor(w_T, device), w_E=tensor(w_E, device))


def split_plan_from_numpy(s, sub_up, sub_dn, p_up, p_dn, r, utility, per_layer_utility,
                          iters, rounding_violations, device=None) -> SplitPlan:
    """A reference SplitPlan, its fields given as numpy arrays or scalars
    under their own names, as tensors on ``device``: s, the subchannels and
    iters int32, the rest float32."""
    return SplitPlan(s=tensor(s, device), sub_up=tensor(sub_up, device),
                     sub_dn=tensor(sub_dn, device), p_up=tensor(p_up, device),
                     p_dn=tensor(p_dn, device), r=tensor(r, device),
                     utility=tensor(utility, device),
                     per_layer_utility=tensor(per_layer_utility, device),
                     iters=tensor(iters, device),
                     rounding_violations=tensor(rounding_violations, device))


def plan_state_from_numpy(norms: dict, moms=None, opt_steps=None, gains=None,
                          device=None) -> PlanState:
    """The warm-start payload of a reference PlanState: norms is the dict of
    stacked per-split optima, moms the (m1, m2) pair of such dicts, opt_steps
    the per-split optimizer steps and gains the planned epoch's g_up."""
    return PlanState(
        plan=None, norms=_tree(dict(norms), device),
        moms=_tree(None if moms is None else tuple(dict(m) for m in moms), device),
        opt_steps=_tree(opt_steps, device), gains=_tree(gains, device))


def fleet_plan_state_from_numpy(norms: dict, moms=None, opt_steps=None, gains=None,
                                device=None) -> PlanState:
    """The warm-start payload of a reference fleet PlanState (plan_many /
    replan_many): every leaf leads with the fleet dim B, norms (B, F+1, U, M)
    and (B, F+1, U), opt_steps (B, F+1), gains (B, U, N, M)."""
    beta = np.shape(norms["beta_up"])
    if len(beta) != 4:
        raise ValueError(f"a fleet state's norms are (B, F+1, U, M); got beta_up {beta}")
    return plan_state_from_numpy(norms, moms, opt_steps, gains, device)


def scenario_state_from_numpy(pos, waypoint, ap_pos, h_up, h_dn, epoch,
                              device=None) -> ScenarioState:
    """A reference ScenarioState (one scenario's, or a fleet's with every
    array leading with B): positions and waypoints ([B,] U, 2), AP positions
    ([B,] N, 2), complex64 coefficients ([B,] U, N, M), and the epoch (a
    fleet's members must share it: the port's epoch is one counter)."""
    epochs = np.unique(np.asarray(epoch))
    if epochs.size != 1:
        raise ValueError(f"the members' epochs differ ({epochs.tolist()}); a fleet "
                         "steps together")
    return ScenarioState(
        mob=MobilityState(pos=tensor(pos, device), waypoint=tensor(waypoint, device)),
        ap_pos=tensor(ap_pos, device), h_up=tensor(h_up, device),
        h_dn=tensor(h_dn, device), epoch=int(epochs[0]))


def _named(cls, fields: dict, device):
    """A NamedTuple of tensors from numpy fields under the tuple's names."""
    missing = set(cls._fields) - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(*(tensor(fields[f], device) for f in cls._fields))


def stream_state_from_numpy(session, epoch, offered, device=None) -> StreamState:
    """A reference StreamState: the (U,) session mask, the epoch (the
    port's draws counter, a Python int) and the offered count."""
    return StreamState(session=tensor(session, device), epoch=int(np.asarray(epoch)),
                       offered=tensor(offered, device))


def batch_state_from_numpy(device=None, **fields) -> BatchState:
    """A reference BatchState, its fields as numpy arrays under their names."""
    return _named(BatchState, fields, device)


def qos_state_from_numpy(device=None, **fields) -> QosState:
    """A reference QosState, its fields as numpy arrays under their names."""
    return _named(QosState, fields, device)


def telemetry_state_from_numpy(device=None, **fields) -> TelemetryState:
    """A reference TelemetryState, its fields as numpy arrays under their
    names."""
    return _named(TelemetryState, fields, device)


def fault_state_from_numpy(link_down, ap_down, device=None) -> FaultState:
    return FaultState(link_down=tensor(link_down, device), ap_down=tensor(ap_down, device))


def _fields(obj) -> dict:
    """The fields of a reference object (a NamedTuple, a dataclass or a
    dict) by name."""
    if isinstance(obj, dict):
        return dict(obj)
    if hasattr(obj, "_asdict"):
        return obj._asdict()
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def serving_state_from_numpy(device_tree: dict, host: dict, seed: int,
                             device=None) -> tuple[dict, dict]:
    """The reference OnlineLoop.serving_state(), its device tree as numpy
    leaves in the reference's types (leaves.npz unflattened with the
    reference's treedef), as the port's ``(device_tree, host)`` for
    OnlineLoop.load_serving_state. The reference's PRNG ``key`` is not
    carried: the packages draw from different generators, so the port's
    episode goes on from ``seed``'s base seed (OnlineLoop.seeds)."""
    d = device_tree
    ps = _fields(d["server_state"])
    state = plan_state_from_numpy(ps["norms"], ps["moms"], ps["opt_steps"], ps["gains"],
                                  device)
    state = dataclasses.replace(
        state, plan=split_plan_from_numpy(**_fields(ps["plan"]), device=device),
        total_iters=tensor(ps["total_iters"], device),
        warm_rho=None if ps["warm_rho"] is None else tensor(ps["warm_rho"], device))
    sc = _fields(d["sc"])
    mob = _fields(sc.pop("mob"))
    st = _fields(d["st"])
    out = {
        "plan": split_plan_from_numpy(**_fields(d["plan"]), device=device),
        "rates": _named(FaultRates, _fields(d["rates"]), device),
        "sc": scenario_state_from_numpy(mob["pos"], mob["waypoint"], device=device, **sc),
        "st": stream_state_from_numpy(st["session"], st["epoch"], st["offered"], device),
        "bt": batch_state_from_numpy(device, **_fields(d["bt"])),
        "qs": qos_state_from_numpy(device, **_fields(d["qs"])),
        "tel": telemetry_state_from_numpy(device, **_fields(d["tel"])),
        "fs": fault_state_from_numpy(device=device, **_fields(d["fs"])),
        "server_state": state,
        "iters_acc": tensor(d["iters_acc"], device),
    }
    return out, dict(host, base=OnlineLoop.seeds(seed)["base"])


def _layer(tree, i: int):
    return {k: _layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def model_params_from_numpy(model, tree: dict):
    """Load the reference Model.init pytree, given as numpy arrays, into the
    port's Model: top leaves as they are, each stage's stacked leaves
    [L, ...] split into its L layers. Every leaf is cast to the port's
    storage dtype on the model's device (bf16, or float32 where the
    reference uses it so: norms, the cross blocks' xgate and the RG-LRU and
    xLSTM gates; float32 masters in a trainable model). On a model built on
    a mesh each whole leaf is cut to this rank's shard (the reference's
    Model(cfg, tp_size=M) tree, the flat layout's padded wq / wo / bq
    included; a rank's experts, xLSTM heads and gate columns, every
    family's). Returns the model."""
    return model.load_params_(_port_layout(model, tree, model.device))


def _port_layout(model, tree: dict, device) -> dict:
    """A reference parameter-shaped tree (top leaves, and "stages": one dict
    of [L, ...] stacked leaves a stage) in Model.param_tree()'s layout (a
    list of per-layer dicts a stage), float32 on ``device``."""
    if len(tree["stages"]) != len(model.stage_layers):
        raise ValueError(f"{len(tree['stages'])} stages in the tree, "
                         f"{len(model.stage_layers)} in the model")
    out = _from_numpy({k: v for k, v in tree.items() if k != "stages"}, device)
    out["stages"] = [[_from_numpy(_layer(st, i), device) for i in range(len(layers))]
                     for st, layers in zip(tree["stages"], model.stage_layers)]
    return out


def train_state_from_numpy(model, params: dict, m: dict, v: dict, opt_step, step):
    """The reference's TrainState (params, AdamWState(step, m, v), step) of
    any family, its trees given as numpy arrays, as the port's
    runtime.train.TrainState on a Model(trainable=True) of the same
    config, so a JAX state trains on in the port: the params loaded into
    the model's float32 masters (the state's params are the model's own
    parameters), m and v as float32 trees in the same layout, the steps
    int32. On a model built on a mesh, m and v are cut to this rank's
    shard, as the params are (the data axes' slice of each leaf FSDP splits
    over them too, once Model.use_fsdp ran). Returns it."""
    from repro_torch.optim import AdamWState
    from repro_torch.runtime.train import TrainState
    if not model.trainable:
        raise ValueError("a TrainState needs a Model(trainable=True): float32 masters")
    dev = model.device
    model_params_from_numpy(model, params)
    opt = AdamWState(step=tensor(opt_step, dev), m=_shard(model, _port_layout(model, m, dev)),
                     v=_shard(model, _port_layout(model, v, dev)))
    return TrainState(params=model.param_tree(), opt=opt, step=tensor(step, dev))


def _shard(model, tree):
    """A whole tree shaped as the model's param_tree() cut to this rank's
    shard (Model.param_slices), each leaf contiguous."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x if cut is None else x[cut].contiguous()
                                    for x, cut in zip(leaves, model.param_slices(),
                                                      strict=True)])


def train_state_whole(model, state):
    """The inverse of cutting a TrainState to a rank's shard, for a
    checkpoint: every params, m and v leaf whole on every rank, the slices
    of a leaf that FSDP splits over the data axes gathered over them (the
    model's tp.DataShards), then the shards of a leaf split over the mesh's
    "model" axis over it (the model's tp.TP), each an all-reduce of a
    zero-filled whole buffer, and a DTensor leaf (ZeRO-1's moments) by
    full_tensor(). A state of a model off a mesh, or already whole, passes
    through with only its DTensors gathered. Every rank of the mesh calls
    it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.train import TrainState
    dims, data_dims = model.model_dims(), model.data_dims()
    shapes = [tuple(x.shape) for x in tree_flatten(model.param_shapes())[0]]

    def whole(tree):
        leaves, treedef = tree_flatten(tree)
        out = []
        for x, d, dd, shape in zip(leaves, dims, data_dims, shapes, strict=True):
            if isinstance(x, DTensor):
                x = x.full_tensor()
            with torch.no_grad():
                if dd >= 0 and x.shape[dd] != shape[dd]:
                    x = model.fsdp.gather_leaf(x.detach(), dd)
                if d >= 0 and tuple(x.shape) != shape:
                    x = model.tp.gather(x.detach(), d)
            out.append(x)
        return tree_unflatten(treedef, out)
    return TrainState(params=whole(state.params),
                      opt=state.opt._replace(m=whole(state.opt.m), v=whole(state.opt.v)),
                      step=state.step)


def caches_from_numpy(tree, like, model=None):
    """The reference's serving caches (Model.prefill / make_caches: KV,
    RG-LRU and xLSTM stage caches, None for a stage without one, "pos", and
    "enc_out" / "frontend"), given as numpy arrays, as the port's: each leaf
    in the dtype and on the device of the matching leaf of ``like`` (a port
    cache tree of the same model, batch and max_len, e.g.
    Model.make_caches). With ``model`` built on a mesh, the whole tree is
    first cut to this rank's shard (Model.local_caches: the xLSTM states
    split on hd, "enc_out" / "frontend" on the batch and whole over
    "model"), as ``like`` holds it. A leaf of another shape raises
    ValueError."""
    if model is not None:
        tree = model.local_caches(tree)
    if like is None or tree is None:
        if like is not None or tree is not None:
            raise ValueError(f"cache entry {type(tree).__name__}, expected "
                             f"{type(like).__name__}")
        return None
    if isinstance(like, dict):
        if set(tree) != set(like):
            raise ValueError(f"cache keys {sorted(tree)}, expected {sorted(like)}")
        return {k: caches_from_numpy(tree[k], like[k]) for k in like}
    if isinstance(like, list):
        return [caches_from_numpy(t, v) for t, v in zip(tree, like, strict=True)]
    a = np.asarray(tree)
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"cache leaf of shape {tuple(a.shape)}, expected {tuple(like.shape)}")
    # bf16 arrays from JAX widen exactly to float32 on the way
    a = a.astype(np.float32) if like.is_floating_point() else np.array(a)
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def to_numpy(x):
    """Tensors (alone, or in dicts, tuples, lists and dataclasses) to numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return x
