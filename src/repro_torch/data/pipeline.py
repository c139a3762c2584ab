"""Deterministic synthetic data pipeline.

Batch content is a pure function of (seed, step, process_index): the numpy
stream is the JAX package's, so the tokens are equal to its tokens; only the
container differs (torch tensors on ``device``). Stateless-resumable: a
restarted job reproduces the exact stream from its step, with no iterator
state in checkpoints. SyntheticLM prefetches batches on a background thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device


def make_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
               frontend_shape=None, process_index: int = 0, process_count: int = 1,
               device=None) -> dict:
    """Markov-ish synthetic LM stream (not uniform noise: loss can improve).
    tokens and targets are int32 (local, seq). With frontend_shape (Sf, D),
    "frontend" (local, Sf, D) bf16 is 0.1 * standard normal, drawn after the
    tokens from the same numpy generator: the audio and vision archs'
    stand-in for a conv or image encoder's output."""
    dev = resolve_device(device)
    local = batch // process_count
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, process_index]))
    # blocky structure: repeat short motifs so there is signal to learn
    motifs = rng.integers(0, vocab, size=(local, 8), dtype=np.int32)
    reps = seq // 8 + 1
    toks = np.tile(motifs, (1, reps))[:, :seq]
    noise = rng.integers(0, vocab, size=(local, seq), dtype=np.int32)
    mask = rng.random((local, seq)) < 0.1
    toks = np.where(mask, noise, toks).astype(np.int32)
    out = {
        "tokens": torch.from_numpy(toks).to(dev),
        "targets": torch.from_numpy(np.roll(toks, -1, axis=1)).to(dev),
    }
    if frontend_shape is not None:
        f = rng.standard_normal((local, *frontend_shape)).astype(np.float32)
        out["frontend"] = torch.from_numpy(0.1 * f).to(dev).to(torch.bfloat16)
    return out


class SyntheticLM:
    """Prefetching iterator over make_batch(seed, step, ...), from
    ``start_step`` on. The worker thread draws each batch on the CPU (numpy,
    then CPU tensors) up to ``prefetch`` ahead; __next__ moves it to
    ``device`` on the caller's thread, so no other thread touches the card.
    close() stops the worker."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, frontend_shape=None,
                 start_step: int = 0, prefetch: int = 2, device=None):
        self.seed, self.batch, self.seq, self.vocab = seed, batch, seq, vocab
        self.frontend_shape = frontend_shape
        self.step = start_step
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            b = make_batch(self.seed, s, self.batch, self.seq, self.vocab,
                           self.frontend_shape, device="cpu")
            self._q.put((s, b))
            s += 1

    def __next__(self) -> dict:
        s, b = self._q.get()
        self.step = s + 1
        return {k: v.to(self.device) for k, v in b.items()}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
