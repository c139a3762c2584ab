"""Top-k gradient compression with error feedback (Lin et al., "Deep
Gradient Compression", arXiv:1712.01887, adapted): each shard sends the top
k fraction of |g| (values and flat indices), and the unsent residual is
carried into the next step.

error_feedback_update is the one-device view; compressed_psum the sparse
all-reduce over a data-parallel process group.
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


def compressed_psum(g: torch.Tensor, group, residual: torch.Tensor, k_frac: float = 0.01):
    """Sparse all-reduce over a process group (None: the default group):
    top-k per rank, an all_gather of the values and their int32 indices,
    and a local scatter-add. Returns (the sum of every rank's sparse g_hat,
    this rank's new residual). Indices collide across ranks, so the ranks'
    contributions are added rank by rank in rank order, never in one
    index_add_ over all of them (atomics on the card): two calls give the
    same bits. Within a rank the indices are distinct. Comm volume 2 k_frac
    of the dense tensor a rank, instead of a dense ring all-reduce."""
    import torch.distributed as dist
    acc = g + residual
    vals, idx = compress_topk(acc, k_frac)
    new_residual = acc - decompress_topk(vals, idx, g.shape, g.dtype)
    world = dist.get_world_size(group)
    all_vals = [torch.empty_like(vals) for _ in range(world)]
    all_idx = [torch.empty_like(idx) for _ in range(world)]
    dist.all_gather(all_vals, vals, group=group)
    dist.all_gather(all_idx, idx, group=group)
    flat = torch.zeros(g.numel(), dtype=g.dtype, device=g.device)
    for v, i in zip(all_vals, all_idx):
        flat.index_add_(0, i.long(), v.to(g.dtype))
    return flat.reshape(g.shape), new_residual
