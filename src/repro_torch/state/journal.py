"""Flight recorder: a deterministic replay journal for the online loop.

The loop's entire host-visible trace per epoch is tiny -- the packed
``(health << 16) | s`` plan word, the QoS trigger bit, the ladder stage --
and all of its device-side randomness is drawn from generators seeded by
``fold_in(base, epoch)``, so an episode is fully determined by (seed,
fault-rate swap schedule, epoch count). The journal records exactly that:
one JSONL line per event, each line carrying a CRC-32 of its canonical
payload (``json.dumps(sort_keys=True)``) so a torn tail (the crash case) or
a tampered record is detected rather than replayed. The line format is the
JAX package's, so a journal written by either package reads in the other.

Record kinds:

  start     {seed, fingerprint}                 episode begins (reset seed)
  epoch     {t, word, trigger, stage}           one served epoch's trace
  rates     {t, rates}                          set_fault_rates swap
  snapshot  {t, path}                           a snapshot was cut
  restore   {t, from}                           supervisor resumed from
                                                ``from`` after a crash at t

``effective_trajectory`` collapses restore rewinds (epochs re-executed
after a resume supersede nothing -- bit-exact resume means they *equal*
the originals, which the divergence detector verifies). ``replay`` re-runs
the episode from the journal alone and reports the first epoch, if any,
whose served (s*, health, trigger) diverges from the recorded word.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Callable

from repro_torch.faults.guards import PLAN_WORD_SHIFT
from repro_torch.faults.injectors import FaultConfig

# Host reads made by replay (the served plan word, one an epoch) since the
# last reset_counts().
COUNTS = {"host_reads": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _crc(payload: dict[str, Any]) -> int:
    return zlib.crc32(json.dumps(payload, sort_keys=True).encode())


def pack_word(health: int, s: int) -> int:
    """The journal's epoch word, identical to the device-side packing the
    loop reads (faults.guards.plan_word): ``(health << 16) | s``."""
    return (int(health) << PLAN_WORD_SHIFT) | int(s)


def unpack_word(word: int) -> tuple[int, int]:
    return word >> PLAN_WORD_SHIFT, word & ((1 << PLAN_WORD_SHIFT) - 1)


class FlightRecorder:
    """Append-only JSONL journal writer. Every record is flushed on write
    (a crash loses at most the line being written, which the reader's CRC
    check drops); the file handle is opened lazily and appends, so a
    restarted supervisor keeps journaling into the same flight record."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _emit(self, payload: dict[str, Any]) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
        rec = dict(payload)
        rec["crc"] = _crc(payload)
        self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
        self._fh.flush()

    def record_start(self, seed: int, fingerprint: str) -> None:
        self._emit({"kind": "start", "seed": int(seed),
                    "fingerprint": fingerprint})

    def record_epoch(self, t: int, s: int, health: int, trigger: bool,
                     stage: str) -> None:
        self._emit({"kind": "epoch", "t": int(t),
                    "word": pack_word(health, s),
                    "trigger": bool(trigger), "stage": stage})

    def record_rates(self, t: int, rates: dict[str, float]) -> None:
        self._emit({"kind": "rates", "t": int(t), "rates": rates})

    def record_snapshot(self, t: int, path: str) -> None:
        self._emit({"kind": "snapshot", "t": int(t), "path": path})

    def record_restore(self, t: int, from_epoch: int) -> None:
        self._emit({"kind": "restore", "t": int(t),
                    "from": int(from_epoch)})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_journal(path: str) -> tuple[list[dict[str, Any]], bool]:
    """Parse a journal; returns ``(records, clean)``. Reading stops at the
    first unparseable or CRC-failing line: a torn tail (crash mid-write) is
    expected and simply truncates, so ``clean=False`` + every record up to
    the tear. A mid-file tamper truncates the same way -- everything after
    an untrusted line is untrusted."""
    records: list[dict[str, Any]] = []
    clean = True
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    crc = rec.pop("crc")
                except (json.JSONDecodeError, KeyError, TypeError, AttributeError):
                    clean = False
                    break
                if _crc(rec) != crc:
                    clean = False
                    break
                records.append(rec)
    except FileNotFoundError:
        return [], False
    return records, clean


def effective_trajectory(records: list[dict[str, Any]]) -> dict[str, Any]:
    """Collapse the journal into the episode's effective host trace:

      epochs  {t: epoch-record}  last write wins (a resume re-executes
              epochs k+1.. after a restore record; bit-exact resume means
              re-executions equal the originals -- ``replay`` checks that)
      rates   [(t, FaultConfig kwargs)]  swap schedule, restore-rewound
      seed    from the first start record (None when the journal starts
              mid-episode)
    """
    epochs: dict[int, dict[str, Any]] = {}
    rates: list[tuple[int, dict[str, float]]] = []
    seed = None
    fingerprint = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "start":
            if seed is None:
                seed = rec["seed"]
                fingerprint = rec["fingerprint"]
        elif kind == "epoch":
            epochs[rec["t"]] = rec
        elif kind == "rates":
            rates.append((rec["t"], rec["rates"]))
        elif kind == "restore":
            # epochs t > from were lost to the crash and will re-execute;
            # rate swaps journaled after the restore point re-apply too.
            k = rec["from"]
            rates = [(t, r) for t, r in rates if t <= k]
    return {"seed": seed, "fingerprint": fingerprint, "epochs": epochs,
            "rates": rates}


def replay(records: list[dict[str, Any]], factory: Callable[[], Any],
           n_epochs: int | None = None) -> dict[str, Any]:
    """Deterministically re-run a journaled episode and diff it.

    ``factory`` builds a fresh OnlineLoop configured exactly as the
    recorded one (the start record's fingerprint is checked against it).
    The journal supplies the seed and the fault-rate swap schedule -- the
    only host inputs; everything else is drawn from fold_in-seeded
    generators on the device. Returns

      {"epochs": n, "divergence": None | {"t", "expected", "got"}}

    where divergence reports the FIRST epoch whose served plan word,
    trigger, or ladder stage differs from the journal. None means the
    journal reproduces the s*/health trajectory exactly. Each journaled
    epoch reads the loop's packed plan word once (``COUNTS``)."""
    traj = effective_trajectory(records)
    if traj["seed"] is None:
        raise ValueError("journal has no start record; cannot replay")
    loop = factory()
    fp = loop.config_fingerprint()
    if traj["fingerprint"] != fp:
        raise ValueError(
            f"journal fingerprint {traj['fingerprint']} does not match the "
            f"factory's loop ({fp})")
    epochs = traj["epochs"]
    last_t = max(epochs) if epochs else 0
    n = last_t if n_epochs is None else min(n_epochs, last_t)
    swaps = dict(traj["rates"])  # t -> rates kwargs (post-epoch-t swap)
    loop.reset(traj["seed"])
    if 0 in swaps:
        loop.set_fault_rates(FaultConfig(**swaps[0]))
    divergence = None
    for _ in range(n):
        out, trigger = loop.step_epoch()
        t = loop.host_epoch
        rec = epochs.get(t)
        if rec is not None:
            COUNTS["host_reads"] += 1
            got = {"word": int(loop.served_word(out)),
                   "trigger": bool(trigger),
                   "stage": loop.ladder.stage if loop.ladder is not None
                   else "normal"}
            exp = {"word": rec["word"], "trigger": rec["trigger"],
                   "stage": rec["stage"]}
            if got != exp:
                divergence = {"t": t, "expected": exp, "got": got}
                break
        if t in swaps:
            loop.set_fault_rates(FaultConfig(**swaps[t]))
    return {"epochs": n, "divergence": divergence}
