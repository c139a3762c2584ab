"""Top-k gradient compression with error feedback (Lin et al., "Deep
Gradient Compression", arXiv:1712.01887, adapted): each shard sends the top
k fraction of |g| (values and flat indices), and the unsent residual is
carried into the next step.

The one-device view. The sparse all-reduce over a data-parallel group
(compressed_psum) waits for the port of runtime/sharding.
"""
from __future__ import annotations

import math

import torch


def compress_topk(g: torch.Tensor, k_frac: float = 0.01):
    """(values, int32 flat indices) of the top-k |entries|, k = max(1,
    int(size * k_frac)), largest first."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * k_frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx.to(torch.int32)


def decompress_topk(values, idx, shape, dtype):
    """A dense tensor of ``shape`` with the values added at the flat indices."""
    out = torch.zeros(math.prod(shape), dtype=dtype, device=values.device)
    return out.index_add_(0, idx.long(), values.to(dtype)).reshape(shape)


def error_feedback_update(g, residual, k_frac: float = 0.01):
    """compress(g + residual) -> (g_hat, new residual = g + residual - g_hat):
    g_hat is what a shard would send."""
    acc = g + residual
    vals, idx = compress_topk(acc, k_frac)
    g_hat = decompress_topk(vals, idx, g.shape, g.dtype)
    return g_hat, acc - g_hat
