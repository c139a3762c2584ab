"""Logical-axis -> mesh-axis sharding rules on torch.distributed (neutral
module: the models and the runtime import it without circular imports).

A mesh is a torch.distributed.device_mesh.DeviceMesh with named dims. A
spec is a tuple with one entry a tensor dim: None (replicated), a mesh-axis
name, or a tuple of names (the dim split over those axes jointly, the
first the major one), as jax.sharding.PartitionSpec holds them.
``placements`` turns a spec into DTensor placements (Shard(d) /
Replicate(), one a mesh dim). The rule functions (axis_size, spec_for,
fleet_axis) read only the mesh's axis sizes, so they also take a plain
{axis: size} mapping and run without a process group.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch

from repro_torch.core.types import Tensor, tree_map

# logical axis -> preferred mesh axis (or tuple for joint sharding)
RULES: dict[str | None, str | tuple | None] = {
    "vocab": "model",
    "qkv": "model",          # flattened heads*hd projections
    "kv": "model",           # flattened kv_heads*hd
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",      # expert parallelism
    "experts_row": None,     # router output dim: small, replicate
    "lru": "model",
    "lru_out": None,         # second dim of the square lru mats: replicate
    "embed": None,           # residual stream replicated (TP gathers on it)
    "layers": None,
    "batch": ("pod", "data"),
    "seq": None,
    "kvseq": "model",        # decode KV-cache sequence sharding (flash-decode)
    "fleet": "fleet",        # planner fleet axis (one scenario batch per device)
    None: None,
}


FLEET_AXIS = "fleet"


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("the mesh's dims need names (mesh_dim_names)")
    return dict(zip(names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the port's jax.sharding.NamedSharding."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    Shard(d) where tensor dim d's entry names that axis, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                where[ax] = d
    return [Shard(where[ax]) if ax in where else Replicate() for ax in mesh_shape(mesh)]


def _device_type(device) -> str:
    from repro_torch.device import resolve_device
    return resolve_device(device).type


def fleet_mesh(n_devices: int | None = None, axis: str = FLEET_AXIS, device=None):
    """A 1-D mesh over the ranks of the default process group for fleet
    planning (PlannerEngine.shard(fleet_mesh()) splits the fleet dim of
    plan_many / replan_many over it), on the card unless ``device`` says
    "cpu". ``n_devices`` (None: the world) must be the world size: a rank
    outside the mesh would have no slice of the fleet."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("fleet_mesh needs a process group: call "
                           "repro_torch.launch.mesh.init_process_group first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"fleet_mesh({n}): the process group has {world} ranks; a fleet "
                         "mesh spans every rank")
    return DeviceMesh(_device_type(device), torch.arange(n), mesh_dim_names=(axis,))


def fleet_axis(mesh) -> str:
    """The mesh axis carrying the fleet dim: 'fleet' when present, else the
    first axis (so a plain 1-D ('data',) mesh also works)."""
    shape = mesh_shape(mesh)
    if FLEET_AXIS in shape:
        return FLEET_AXIS
    return next(iter(shape))


def fleet_sharding(mesh) -> NamedSharding:
    """The leading (fleet) dim split over the mesh's fleet axis."""
    return NamedSharding(mesh, (fleet_axis(mesh),))


def shard_fleet(tree, mesh):
    """A fleet-batched tree (stacked NetworkEnv, fleet ScenarioState, fleet
    PlanState) with every tensor leaf a DTensor whose leading dim is split
    over the mesh's fleet axis (Shard(0)); ``full_tensor()`` gives the whole
    fleet back. Every rank passes the same whole fleet; the values are
    scattered from the mesh's first rank, as one host's device_put would
    place them."""
    from torch.distributed.tensor import distribute_tensor
    place = fleet_sharding(mesh).placements
    return tree_map(lambda x: distribute_tensor(x, mesh, place), tree)


def unshard(tree):
    """The tree with every DTensor leaf gathered whole (full_tensor()); other
    leaves pass through."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def replicate(tree, mesh):
    """The tree with every tensor leaf made equal on all ranks of the mesh
    (broadcast from its first rank), as plain tensors: the port's
    device_put(x, NamedSharding(mesh, P()))."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    def rep(x):
        if isinstance(x, DTensor):
            return x.full_tensor()
        return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim).to_local()
    return tree_map(rep, tree)


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(axis_size(mesh, n) for n in name)
    return mesh_shape(mesh).get(name, 1)


def spec_for(mesh, logical_axes: tuple, shape: tuple, fsdp: bool = False) -> tuple:
    """Resolve logical axes to a spec. A mesh axis is used at most once per
    tensor (first logical dim wins: e.g. MoE (experts, embed, mlp) shards
    experts over 'model' and leaves mlp replicated); non-divisible dims are
    dropped to replication.

    fsdp=True (parameters only): a dim whose logical axis is 'embed'
    additionally shards over the data-parallel axes (ZeRO-3 style)."""
    sizes = mesh_shape(mesh)
    out = []
    used: set = set()

    def assign(mesh_ax, dim):
        if isinstance(mesh_ax, tuple):
            mesh_ax = tuple(a for a in mesh_ax if a in sizes and a not in used)
            if not mesh_ax:
                return None
        elif mesh_ax not in sizes or mesh_ax in used:
            return None
        size = axis_size(sizes, mesh_ax)
        if dim % size == 0 and dim >= size:
            used.update(mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,))
            return mesh_ax
        return None

    for ax, dim in zip(logical_axes, shape):
        mesh_ax = RULES.get(ax, None)
        got = assign(mesh_ax, dim) if mesh_ax is not None else None
        if got is None and fsdp and ax == "embed":
            got = assign(tuple(a for a in ("pod", "data") if a in sizes), dim)
        out.append(got)
    return tuple(out)


def local_slice(shape: tuple, spec: tuple, sizes: dict, coord: dict) -> tuple:
    """The slices of a leaf of ``shape`` that the rank at ``coord`` (axis ->
    index) holds under ``spec`` (one entry a dim: None, an axis or a tuple of
    axes, the first the major one) on a mesh of ``sizes`` (axis -> size)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        index, count = 0, 1
        for ax in axes:
            index = index * sizes[ax] + coord.get(ax, 0)
            count *= sizes[ax]
        if dim % count:
            raise ValueError(f"dim {dim} does not split over {axes} of {count}")
        chunk = dim // count
        out.append(slice(index * chunk, (index + 1) * chunk) if count > 1 else slice(None))
    return tuple(out)


def local_shape(shape: tuple, spec: tuple, sizes: dict) -> tuple:
    """The shape of each rank's slice of a leaf of ``shape`` under ``spec``."""
    return tuple(dim // axis_size(sizes, entry) if entry is not None else dim
                 for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))



def ambient_mesh():
    """The mesh activated with ``with mesh:`` (DeviceMesh's own context), or
    None."""
    from torch.distributed import device_mesh
    stack = getattr(getattr(device_mesh, "_mesh_resources", None), "mesh_stack", None)
    return stack[-1] if stack else None


def constrain(x: Tensor, logical_axes: tuple) -> Tensor:
    """The port's with_sharding_constraint, resolved through the
    divisibility-aware rules against the ambient mesh; a no-op outside a
    mesh context. A DTensor is redistributed to the resolved placements; a
    plain tensor is a rank's own shard already and passes through: the
    data-parallel step splits the batch before the model, and on the
    explicit tensor-parallel path (models/tp.py) each rank computes on its
    local shard with the collectives written out, so nothing is
    redistributed."""
    m = ambient_mesh()
    if m is None:
        return x
    spec = spec_for(m, logical_axes, tuple(x.shape))
    if all(a is None for a in spec):
        return x
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(m, placements(m, spec))
    return x
