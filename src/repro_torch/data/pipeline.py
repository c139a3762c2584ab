"""Deterministic synthetic data pipeline.

Batch content is a pure function of (seed, step, process_index): the numpy
stream is the JAX package's, so the tokens are equal to its tokens; only the
container differs (torch tensors on ``device``).
"""
from __future__ import annotations

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
