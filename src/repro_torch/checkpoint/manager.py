"""Fault-tolerant checkpointing of tensor trees as numpy files.

Properties:
  * atomic: writes go to <dir>/tmp.<step>, then are *promoted* into
    step_<N>. Promotion never opens a lost-update window: an existing
    step_<N> is renamed aside (atomic), the tmp dir os.replace's into
    place (atomic), and only then is the aside removed. A crash at any
    instant leaves either the old copy (possibly under the aside name --
    repaired by the next reader/writer) or the new one, never neither.
  * validated: meta.json records the treedef string, per-leaf dtypes,
    shapes and CRC-32s; load_checkpoint verifies all of them against the
    caller's ``tree_like`` and the bytes actually read, raising
    SnapshotIntegrityError instead of silently mis-unflattening.
  * async: save_async() returns once the leaves are host copies (taken on
    the caller's thread, so later in-place updates of live tensors cannot
    reach them); a background thread serializes.
  * bounded retention: the keep_n newest checkpoints are retained.

The on-disk layout is the JAX package's (``step_<8 digits>/``,
``shard_<process>.npz`` with keys ``a<i>``, ``meta.json``), so either
package's reader finds the same files. Trees are flattened with
core.types.tree_flatten; Python int leaves are stored as 0-d int64 arrays. ``restore`` places the leaves on ``device`` (the
card by default) with the caller's dtypes and, given ``shardings`` (a tree
of pshard.NamedSharding), splits each leaf over its mesh: the elastic
restore onto a mesh of any size. Every rank reads the whole arrays and keeps
its own shard, so placing them needs no communication.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.types import TreeDef, host_copies, tree_flatten, tree_unflatten
from repro_torch.device import resolve_device

_STEP_RE = re.compile(r"step_(\d{8})")
_ASIDE_SUFFIX = ".aside"
_INT_LEAF = np.dtype(np.int64)      # a Python int leaf is stored as a 0-d int64


class SnapshotIntegrityError(RuntimeError):
    """On-disk checkpoint/snapshot data does not match what the caller
    expects (treedef / dtype / shape mismatch, checksum failure, missing or
    unreadable shards). Raised instead of silently mis-unflattening; the
    crash supervisor treats it as "this snapshot is corrupt, fall back to
    an older one"."""


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (bfloat16 has none and raises)."""
    return torch.empty((), dtype=dtype).numpy().dtype


def leaf_spec(leaf, kind: str) -> tuple[np.dtype, tuple]:
    """(numpy dtype, shape) of one flattened leaf: a tensor's own, a Python
    int's 0-d int64's."""
    if kind == "tensor":
        return np_dtype(leaf.dtype), tuple(leaf.shape)
    return _INT_LEAF, ()


def host_arrays(leaves: list, kinds: list[str]) -> list[np.ndarray]:
    """Numpy copies of flattened leaves, on the caller's thread: never a view
    of a live tensor (core.types.host_copies: one sync for the lot); int
    leaves as 0-d int64 arrays."""
    copies = iter(host_copies([x for x, k in zip(leaves, kinds) if k == "tensor"]))
    return [next(copies).numpy() if k == "tensor" else np.asarray(x, dtype=_INT_LEAF)
            for x, k in zip(leaves, kinds)]


def _promote(tmp: str, final: str) -> None:
    """Atomically promote ``tmp`` over ``final`` even when ``final`` exists.

    ``os.replace`` cannot replace a non-empty directory, and the obvious
    rmtree-then-replace opens a crash window in which the only copy is
    gone. Rename-aside closes it: the old final moves to ``<final>.aside``
    (atomic), tmp replaces final (atomic), then the aside is deleted.
    ``_recover`` repairs a crash between the renames."""
    aside = final + _ASIDE_SUFFIX
    if os.path.exists(aside):            # stale aside from an old crash
        shutil.rmtree(aside)
    had_old = os.path.exists(final)
    if had_old:
        os.rename(final, aside)
    os.replace(tmp, final)
    if had_old:
        shutil.rmtree(aside, ignore_errors=True)


def _recover(directory: str) -> None:
    """Repair interrupted promotions: a stranded ``<final>.aside`` whose
    final is missing is renamed back into place (the crash hit between the
    two renames); one whose final exists is a superseded copy and is
    removed. Idempotent; called by every reader and writer."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return
    for name in names:
        if not name.endswith(_ASIDE_SUFFIX):
            continue
        final = os.path.join(directory, name[: -len(_ASIDE_SUFFIX)])
        aside = os.path.join(directory, name)
        if os.path.exists(final):
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.rename(aside, final)


def list_steps(directory: str) -> list[int]:
    """Step numbers of complete checkpoints under ``directory``, ascending.
    Only exact ``step_<8 digits>`` names count -- tmp dirs and asides are
    never mistaken for checkpoints."""
    _recover(directory)
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for n in names
                  if (m := _STEP_RE.fullmatch(n)))


def leaf_crc32(a: np.ndarray) -> int:
    """Content checksum of one leaf (dtype/shape are recorded separately),
    over its C-order bytes, read in place (no copy of a contiguous leaf)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _write_step(directory: str, step: int, arrays: list[np.ndarray], treedef: TreeDef,
                process_index: int = 0) -> str:
    os.makedirs(directory, exist_ok=True)
    _recover(directory)
    tmp = os.path.join(directory, f"tmp.{step}.{process_index}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {
        "step": int(step),
        "treedef": str(treedef),
        "n_leaves": len(arrays),
        "dtypes": [str(a.dtype) for a in arrays],
        "shapes": [list(a.shape) for a in arrays],
        "crc32s": [leaf_crc32(a) for a in arrays],
    }
    np.savez(os.path.join(tmp, f"shard_{process_index}.npz"),
             **{f"a{i}": a for i, a in enumerate(arrays)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    _promote(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree, process_index: int = 0) -> str:
    """Write ``tree`` as checkpoint ``step`` now (synchronous); returns its
    path."""
    flat, treedef = tree_flatten(tree)
    arrays = host_arrays(flat, treedef.leaf_kinds())
    return _write_step(directory, step, arrays, treedef, process_index)


def _read_meta(path: str) -> dict[str, Any]:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotIntegrityError(
            f"{path}: unreadable meta.json ({e})") from e
    for key in ("treedef", "n_leaves", "dtypes", "shapes"):
        if key not in meta:
            raise SnapshotIntegrityError(f"{path}: meta.json missing {key!r}")
    return meta


def validate_leaves(meta: dict[str, Any], flat: list, treedef: TreeDef, path: str,
                    expects: str = "caller expects") -> None:
    """Stored structure, per-leaf dtypes and shapes must match the caller's
    flattened tree exactly -- a mismatch means the caller would
    mis-unflatten."""
    if meta["n_leaves"] != len(flat):
        raise SnapshotIntegrityError(
            f"{path}: {meta['n_leaves']} leaves stored, {expects} {len(flat)}")
    if meta["treedef"] != str(treedef):
        raise SnapshotIntegrityError(
            f"{path}: treedef mismatch\n  stored:   {meta['treedef']}\n"
            f"  expected: {str(treedef)}")
    for i, (leaf, kind) in enumerate(zip(flat, treedef.leaf_kinds())):
        want_dt, want_sh = leaf_spec(leaf, kind)
        got_dt = np.dtype(meta["dtypes"][i])
        got_sh = tuple(meta["shapes"][i])
        if got_dt != want_dt or got_sh != want_sh:
            raise SnapshotIntegrityError(
                f"{path}: leaf {i} is {got_dt}{list(got_sh)}, {expects} "
                f"{want_dt}{list(want_sh)}")


def load_arrays(path: str, name: str, meta: dict[str, Any]) -> list[np.ndarray]:
    """The leaves of ``<path>/<name>``, each checked against meta.json's
    dtype, shape and (where recorded) CRC-32."""
    file = os.path.join(path, name)
    try:
        with np.load(file) as data:
            loaded = [data[f"a{i}"] for i in range(meta["n_leaves"])]
    except Exception as e:  # truncated zip, missing member, missing file
        raise SnapshotIntegrityError(
            f"{file}: unreadable or truncated ({e})") from e
    crcs = meta.get("crc32s")
    for i, a in enumerate(loaded):
        if (str(a.dtype) != meta["dtypes"][i]
                or list(a.shape) != meta["shapes"][i]):
            raise SnapshotIntegrityError(
                f"{file}: leaf {i} is {a.dtype}{list(a.shape)}, meta.json "
                f"says {meta['dtypes'][i]}{meta['shapes'][i]}")
        if crcs is not None and leaf_crc32(a) != crcs[i]:
            raise SnapshotIntegrityError(
                f"{file}: leaf {i} failed its CRC-32 check")
    return loaded


def to_tree(treedef: TreeDef, template: list, arrays: list[np.ndarray], device):
    """``arrays`` as the tree of ``treedef``: tensor leaves on ``device`` with
    the template leaves' dtypes, int leaves as Python ints."""
    leaves = []
    for a, t, kind in zip(arrays, template, treedef.leaf_kinds()):
        if kind == "tensor":
            leaves.append(torch.from_numpy(np.array(a)).to(device=device, dtype=t.dtype))
        else:
            leaves.append(a)
    return tree_unflatten(treedef, leaves)


def place(tree, shardings):
    """``tree`` with each tensor leaf split over the mesh of the
    pshard.NamedSharding at its place in ``shardings`` (a tree of the same
    structure; a None there leaves the leaf whole): a DTensor holding this
    rank's shard of the leaf, which every rank holds whole."""
    if isinstance(tree, torch.Tensor):
        if shardings is None:
            return tree
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tree, shardings.mesh, shardings.placements,
                                 src_data_rank=None)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(place(v, s) for v, s in zip(tree, shardings, strict=True)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings, strict=True))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: place(getattr(tree, f.name),
                                                          getattr(shardings, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def load_checkpoint(directory: str, tree_like, step: int | None = None, device=None,
                    shardings=None):
    """Restore into the structure of ``tree_like`` on ``device`` (None: the
    card), each leaf split by ``shardings`` when given (place). The stored
    meta.json (treedef string, per-leaf dtypes/shapes/CRCs) is validated
    against both ``tree_like`` and the bytes actually read; any mismatch
    raises SnapshotIntegrityError. Returns (tree, step)."""
    steps = list_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    flat, treedef = tree_flatten(tree_like)
    meta = _read_meta(path)
    validate_leaves(meta, flat, treedef, path)
    loaded = load_arrays(path, "shard_0.npz", meta)
    tree = to_tree(treedef, flat, loaded, resolve_device(device))
    return (tree if shardings is None else place(tree, shardings)), step


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save_async(self, step: int, tree) -> None:
        """Checkpoint ``tree`` as ``step``: host copies now, on this thread;
        the write and the retention sweep on a background thread. A write
        error surfaces on the next save_async / wait."""
        self.wait()
        flat, treedef = tree_flatten(tree)
        arrays = host_arrays(flat, treedef.leaf_kinds())

        def work():
            try:
                _write_step(self.directory, step, arrays, treedef)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> int | None:
        steps = list_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, tree_like, device=None, step=None, shardings=None):
        return load_checkpoint(self.directory, tree_like, step, device, shardings)

    def _gc(self) -> None:
        for s in list_steps(self.directory)[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
