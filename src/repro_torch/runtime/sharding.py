"""Runtime sharding: param, cache and batch sharding trees built on the
neutral rules in repro_torch.pshard (re-exported here).

A sharding is a pshard.NamedSharding (a mesh and a spec). The rules read
only the mesh's axis sizes, so a plain {axis: size} mapping stands for a
mesh wherever no tensor is placed. The port's parameters are per layer
(Model.param_tree(): no stacked "layers" dim), so each leaf's spec is the
reference's spec of its stacked leaf without that leading dim.
"""
from __future__ import annotations

from repro_torch.pshard import (  # noqa: F401
    FLEET_AXIS,
    RULES,
    NamedSharding,
    ambient_mesh,
    axis_size,
    constrain,
    fleet_axis,
    fleet_mesh,
    fleet_sharding,
    local_shape,
    local_slice,
    mesh_shape,
    placements,
    replicate,
    shard_fleet,
    spec_for,
    unshard,
)


def _is_axes(x) -> bool:
    """A logical-axes tuple: a leaf of a specs tree."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def tree_shardings(mesh, specs_tree, shapes_tree, fsdp: bool = False):
    """specs_tree: a tree of logical-axes tuples (Model.specs()); shapes_tree:
    the matching tree of tensors (or anything with .shape). Returns the tree
    of NamedSharding."""
    def rec(axes, arr):
        if _is_axes(axes):
            return NamedSharding(mesh, spec_for(mesh, axes, tuple(arr.shape), fsdp=fsdp))
        if isinstance(axes, dict):
            return {k: rec(axes[k], arr[k]) for k in axes}
        if isinstance(axes, (list, tuple)):
            return type(axes)(rec(a, s) for a, s in zip(axes, arr, strict=True))
        raise TypeError(f"tree_shardings: {type(axes).__name__} in the specs tree")
    return rec(specs_tree, shapes_tree)


# --------------------------------------------------------------------------
# activation / data shardings
# --------------------------------------------------------------------------
def batch_spec(mesh, shape: tuple, batch_dim: int = 0, seq_dim: int | None = None,
               seq_axis: str | None = None) -> tuple:
    """Shard the batch dim over (pod, data); optionally sequence over an axis
    (sequence parallelism for batch-1 long-context)."""
    sizes = mesh_shape(mesh)
    axes: list = [None] * len(shape)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = axis_size(sizes, dp)
    if dp and shape[batch_dim] % dp_size == 0 and shape[batch_dim] >= dp_size:
        axes[batch_dim] = dp
    elif "data" in sizes and shape[batch_dim] % sizes["data"] == 0:
        axes[batch_dim] = "data"
    elif seq_dim is not None and seq_axis is None:
        seq_axis = "data"  # batch unshardable -> spill onto sequence
    if (seq_dim is not None and seq_axis is not None
            and shape[seq_dim] % axis_size(sizes, seq_axis) == 0):
        axes[seq_dim] = seq_axis
    return tuple(axes)


def cache_shardings(mesh, caches_shapes, cfg):
    """Shard KV caches (Model.make_caches: stacked over a stage's layers, as
    the reference's): batch over (pod, data) when divisible, else sequence
    over every free axis (long-context single-request decode); kv-heads over
    model when divisible, else the cache sequence shards over model
    (flash-decoding style). Returns the tree of NamedSharding (None entries
    stay None)."""
    sizes = mesh_shape(mesh)
    model = axis_size(sizes, "model")

    def _seq_axes(batch_sharded: bool, kv_on_model: bool, s_dim: int):
        """Choose the sequence-dim sharding for a cache of length s_dim."""
        free = []
        if not batch_sharded:
            free += [a for a in ("pod", "data") if a in sizes]
        if not kv_on_model and "model" in sizes:
            free.append("model")
        while free and s_dim % axis_size(sizes, tuple(free)) != 0:
            free.pop()
        return tuple(free) if free else None

    def resolve(key, arr):
        shape = tuple(arr.shape)
        # KV cache tensors: (L, B, S, KV, hd)
        if key in ("k", "v") and len(shape) == 5:
            axes: list = [None] * 5
            axes[1] = batch_spec(sizes, shape[1:2])[0]
            kv_ok = shape[3] % model == 0 and shape[3] >= model
            if kv_ok:
                axes[3] = "model"
            axes[2] = _seq_axes(axes[1] is not None, kv_ok, shape[2])
            return tuple(axes)
        if key == "pos" and len(shape) == 3:
            axes = [None, batch_spec(sizes, shape[1:2])[0], None]
            kv_ok = cfg.n_kv_heads % model == 0 and cfg.n_kv_heads >= model
            axes[2] = _seq_axes(axes[1] is not None, kv_ok, shape[2])
            return tuple(axes)
        # recurrent states (L, B, ...) / enc_out (B, S, D) / pos (B,)
        if len(shape) >= 2 and key in ("h", "conv", "C", "n", "c", "m"):
            axes = [None] * len(shape)
            axes[1] = batch_spec(sizes, shape[1:2])[0]
            # last dim is a width dim: shard over model when divisible
            if shape[-1] % model == 0 and shape[-1] >= model:
                axes[-1] = "model"
            return tuple(axes)
        if key in ("enc_out", "frontend") and len(shape) == 3:
            return batch_spec(sizes, shape)
        if len(shape) == 1:  # top-level pos counter
            return batch_spec(sizes, shape)
        return (None,) * len(shape)

    def walk(tree, key):
        """The tree's shardings; ``key`` is the dict key a leaf sits under
        (a list entry's is its index, which no rule names)."""
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"[{i}]") for i, v in enumerate(tree))
        return None if tree is None else NamedSharding(mesh, resolve(key, tree))
    return walk(caches_shapes, "")


def map_shardings(fn, shardings, *trees):
    """fn(sharding, *leaves) over a tree of NamedSharding and trees of the
    same structure; returns the tree of results."""
    if isinstance(shardings, NamedSharding):
        return fn(shardings, *trees)
    if shardings is None:       # a stage without a cache
        return None
    if isinstance(shardings, dict):
        return {k: map_shardings(fn, v, *(t[k] for t in trees)) for k, v in shardings.items()}
    if isinstance(shardings, (list, tuple)):
        kids = [map_shardings(fn, v, *(t[i] for t in trees)) for i, v in enumerate(shardings)]
        return type(shardings)(*kids) if hasattr(shardings, "_fields") else type(shardings)(kids)
    raise TypeError(f"map_shardings: {type(shardings).__name__} in a shardings tree")


def sharding_leaves(shardings) -> list:
    """The NamedSharding leaves of a tree in tree_flatten's order (dict keys
    sorted; None entries hold none)."""
    if isinstance(shardings, NamedSharding):
        return [shardings]
    if shardings is None:
        return []
    if isinstance(shardings, dict):
        return [x for k in sorted(shardings) for x in sharding_leaves(shardings[k])]
    return [x for v in shardings for x in sharding_leaves(v)]
