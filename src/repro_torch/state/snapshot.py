"""Versioned serving snapshots: the durable half of the online loop.

A serving snapshot is one atomic directory ``snap_<epoch:08d>`` holding the
loop's complete episode state (OnlineLoop.serving_state):

  leaves.npz   every device-resident leaf -- served plan, fault rates,
               scenario/stream/batch/QoS/telemetry/fault state, the server's
               PlanState (warm Adam payload included) and its GD-iteration
               accumulator -- and the episode's Python counters (the
               scenario's and the stream's epoch), as 0-d int64 arrays
  meta.json    schema version, epoch, the loop's config fingerprint, the
               device treedef string (core.types.TreeDef), per-leaf
               dtype/shape/CRC-32, and the JSON host state (epoch clock,
               base seed, server counters, degradation-ladder state machine)

The file names and formats are the JAX package's. Write path: serialized
into a tmp dir, then promoted with the checkpoint manager's rename-aside
dance -- a crash at any instant leaves either the previous snapshot or the
new one, never a torn directory. ``SnapshotStore`` adds an epoch cadence,
optional async writes (the state is copied to the host on the caller's
thread first, with one sync for the whole tree, so the writer holds host
copies only), and keep-n retention. ``COUNTS`` counts the captures and
their bytes.

Restore path is validating: the stored treedef, per-leaf dtypes/shapes and
checksums are checked against BOTH the bytes read and the live loop's
``state_template`` (the live episode tree, with the engine's PlanState of
the stored kind built from the shapes alone). A failure raises
``SnapshotIntegrityError`` before any leaf is loaded into the loop. The
restored leaves are made on the loop's device with the template's dtypes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
import time
from typing import Any

import numpy as np

from repro_torch.checkpoint.manager import (
    SnapshotIntegrityError,
    _promote,
    _recover,
    host_arrays,
    leaf_crc32,
    load_arrays,
    to_tree,
    validate_leaves,
)
from repro_torch.core.types import tree_flatten

SNAPSHOT_VERSION = 1
_SNAP_FMT = "snap_{:08d}"
_SNAP_RE = re.compile(r"snap_(\d{8})")

# Captures of the loop's state to the host (one sync each) and their bytes,
# since the last reset_counts().
COUNTS = {"captures": 0, "bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


@dataclasses.dataclass(frozen=True)
class SnapshotConfig:
    """Durability knobs: snapshot every ``every`` epochs (the cadence), keep
    the ``keep_n`` newest on disk, write asynchronously unless
    ``asynchronous=False`` (sync writes are for tests and for callers that
    need the snapshot durable before the next epoch)."""

    every: int = 20
    keep_n: int = 3
    asynchronous: bool = True

    def __post_init__(self) -> None:
        if self.every < 1 or self.keep_n < 1:
            raise ValueError("every/keep_n must be >= 1")


def _capture(loop) -> tuple[list[np.ndarray], str, dict[str, Any], int]:
    """Snapshot the loop on the caller's thread: host copies of every leaf
    (one sync) + the host state."""
    device, host = loop.serving_state()
    flat, treedef = tree_flatten(device)
    leaves = host_arrays(flat, treedef.leaf_kinds())
    COUNTS["captures"] += 1
    COUNTS["bytes"] += sum(a.nbytes for a in leaves)
    return leaves, str(treedef), host, int(host["host_epoch"])


def save_snapshot(directory: str, loop) -> str:
    """Write one snapshot of ``loop`` now (synchronous); returns its path."""
    leaves, treedef, host, epoch = _capture(loop)
    return _write(directory, leaves, treedef, host, epoch,
                  loop.config_fingerprint())


def _write(directory: str, leaves: list[np.ndarray], treedef: str,
           host: dict[str, Any], epoch: int, fingerprint: str) -> str:
    os.makedirs(directory, exist_ok=True)
    _recover(directory)
    final = os.path.join(directory, _SNAP_FMT.format(epoch))
    tmp = os.path.join(directory, f"tmp.{epoch}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {
        "version": SNAPSHOT_VERSION,
        "epoch": epoch,
        "fingerprint": fingerprint,
        "treedef": treedef,
        "n_leaves": len(leaves),
        "dtypes": [str(a.dtype) for a in leaves],
        "shapes": [list(a.shape) for a in leaves],
        "crc32s": [leaf_crc32(a) for a in leaves],
        "host": host,
    }
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"a{i}": a for i, a in enumerate(leaves)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    _promote(tmp, final)
    return final


def list_snapshots(directory: str) -> list[int]:
    """Epochs of complete snapshots under ``directory``, ascending."""
    _recover(directory)
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(m.group(1)) for n in names
                  if (m := _SNAP_RE.fullmatch(n)))


def _read_meta(path: str) -> dict[str, Any]:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotIntegrityError(
            f"{path}: unreadable meta.json ({e})") from e
    for key in ("version", "epoch", "fingerprint", "treedef", "n_leaves",
                "dtypes", "shapes", "crc32s", "host"):
        if key not in meta:
            raise SnapshotIntegrityError(f"{path}: meta.json missing {key!r}")
    if meta["version"] != SNAPSHOT_VERSION:
        raise SnapshotIntegrityError(
            f"{path}: snapshot version {meta['version']}, this build reads "
            f"{SNAPSHOT_VERSION}")
    return meta


def load_snapshot(directory: str, loop, epoch: int) -> None:
    """Validate and restore ``snap_<epoch>`` into ``loop`` (which must be
    reset() already -- the snapshot supplies state, not configuration).

    Validation order: meta.json well-formed -> config fingerprint matches
    the live loop -> treedef + per-leaf dtype/shape match the live loop's
    ``state_template`` -> bytes read back match their recorded CRC-32s. Any
    failure raises SnapshotIntegrityError and leaves ``loop`` untouched."""
    path = os.path.join(directory, _SNAP_FMT.format(epoch))
    meta = _read_meta(path)
    live_fp = loop.config_fingerprint()
    if meta["fingerprint"] != live_fp:
        raise SnapshotIntegrityError(
            f"{path}: config fingerprint {meta['fingerprint']} does not "
            f"match the live loop ({live_fp}) -- the snapshot was taken "
            "under a different loop/engine configuration")
    kind = meta["host"].get("plan_state_kind")
    if kind not in ("cold", "warm", "none"):
        raise SnapshotIntegrityError(
            f"{path}: unknown plan_state_kind {kind!r}")
    tflat, tdef = tree_flatten(loop.state_template(kind))
    validate_leaves(meta, tflat, tdef, path, expects="the live loop expects")
    leaves = load_arrays(path, "leaves.npz", meta)
    loop.load_serving_state(to_tree(tdef, tflat, leaves, loop.device), meta["host"])


class SnapshotStore:
    """Cadenced, optionally-async snapshot writer + escalating restorer.

    ``maybe_save(loop)`` is the serving loop's per-epoch hook: it snapshots
    when the epoch clock hits the cadence. ``restore_newest_valid(loop)``
    is the crash supervisor's: it walks snapshots newest-first, skipping
    any that fail integrity validation, and reports what it skipped.
    ``capture_s`` / ``write_s`` / ``restore_s`` hold the wall seconds of
    each capture (on the caller's thread), write (on the writer's) and
    successful restore."""

    def __init__(self, directory: str,
                 cfg: SnapshotConfig = SnapshotConfig()):
        self.directory = directory
        self.cfg = cfg
        self.saves = 0
        self.capture_s: list[float] = []
        self.write_s: list[float] = []
        self.restore_s: list[float] = []
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def maybe_save(self, loop) -> str | None:
        """Snapshot iff the loop's epoch clock is on the cadence (and past
        epoch 0). Returns the final path (the *eventual* path for async
        writes), or None when off-cadence."""
        if loop.host_epoch <= 0 or loop.host_epoch % self.cfg.every != 0:
            return None
        return self.save(loop)

    def save(self, loop) -> str:
        """Snapshot now. The state is copied to the host on the caller's
        thread either way; with ``asynchronous`` the serialization and the
        atomic promote happen on a background thread while the loop keeps
        stepping. Write errors surface on the next save/wait."""
        self.wait()
        t0 = time.perf_counter()
        leaves, treedef, host, epoch = _capture(loop)
        self.capture_s.append(time.perf_counter() - t0)
        fingerprint = loop.config_fingerprint()
        final = os.path.join(self.directory, _SNAP_FMT.format(epoch))

        def work():
            t1 = time.perf_counter()
            _write(self.directory, leaves, treedef, host, epoch, fingerprint)
            self.write_s.append(time.perf_counter() - t1)
            self._gc()

        if not self.cfg.asynchronous:
            work()
            self.saves += 1
            return final

        def background():
            try:
                work()
            except Exception as e:   # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=background, daemon=True)
        self._thread.start()
        self.saves += 1
        return final

    def wait(self) -> None:
        """Join any in-flight async write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def epochs(self) -> list[int]:
        return list_snapshots(self.directory)

    def restore(self, loop, epoch: int | None = None) -> int:
        """Restore the snapshot at ``epoch`` (default: newest) into
        ``loop``; returns the restored epoch. SnapshotIntegrityError on a
        corrupt snapshot, FileNotFoundError when there are none."""
        self.wait()
        epochs = self.epochs()
        if not epochs:
            raise FileNotFoundError(f"no snapshots under {self.directory}")
        epoch = epochs[-1] if epoch is None else epoch
        load_snapshot(self.directory, loop, epoch)
        return epoch

    def restore_newest_valid(self, loop) -> tuple[int, list[int]]:
        """Walk snapshots newest-first until one validates and restores;
        returns ``(restored_epoch, skipped_epochs)``. FileNotFoundError
        when every snapshot is corrupt or none exist -- the supervisor's
        cue to fall to the ladder's cold start."""
        self.wait()
        skipped: list[int] = []
        for epoch in reversed(self.epochs()):
            t0 = time.perf_counter()
            try:
                load_snapshot(self.directory, loop, epoch)
                self.restore_s.append(time.perf_counter() - t0)
                return epoch, skipped
            except SnapshotIntegrityError:
                skipped.append(epoch)
        raise FileNotFoundError(
            f"no valid snapshot under {self.directory} "
            f"(skipped corrupt: {skipped})")

    def _gc(self) -> None:
        for e in list_snapshots(self.directory)[:-self.cfg.keep_n]:
            shutil.rmtree(os.path.join(self.directory, _SNAP_FMT.format(e)),
                          ignore_errors=True)
