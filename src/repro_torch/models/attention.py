"""Attention: GQA with RoPE, in the grouped layout, with a ring-buffer KV
cache.

Attention over a fresh sequence (no cache, or a prefill) runs through
ops.flash_attention: the CUDA kernel on the card, its plain twin on the CPU,
differentiable (the backward kernel) when a training step needs it.
It is the function the JAX package's jnp online-softmax core computes and
its Pallas kernel replaces on a TPU. Decode against the cache is the JAX
package's single-pass path, plain tensor code. Cross attention (kv_src)
projects K and V from another sequence, rotates neither q nor k and masks
nothing: Sq > 8 queries go through the kernel (Sq != Sk), a few queries (a
decode step) through the single-pass path, as the JAX core splits them.

The flat tensor-parallel layout waits for the tensor-parallel slice (ROADMAP
section 1, the sharding item's TP half).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import COMPUTE_DTYPE, ParamDef, at_use, rope

NEG_INF = -1e30


def attn_defs(cfg, cross: bool = False) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, h * hd), ("embed", "qkv")),
        "wk": ParamDef((d, kv * hd), ("embed", "kv")),
        "wv": ParamDef((d, kv * hd), ("embed", "kv")),
        "wo": ParamDef((h * hd, d), ("qkv", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * hd,), ("qkv",), init="zeros")
        defs["bk"] = ParamDef((kv * hd,), ("kv",), init="zeros")
        defs["bv"] = ParamDef((kv * hd,), ("kv",), init="zeros")
    return defs


def _single_pass(q, k, v, q_pos, k_pos, causal: bool, window: int):
    """Attention of a few queries over a cache in one pass (the JAX
    package's decode path): q (B, Sq, KV, G, hd) pre-scaled in bf16, k/v
    (B, Sk, KV, hd), slots with k_pos < 0 empty. Returns (B, Sq, KV, G, hd).
    The scale is rounded to bf16 before the product, as JAX rounds a
    Python float that multiplies a bf16 array (a fill, not a copy from the
    host: a CUDA graph may capture this)."""
    scale = torch.full((), q.shape[-1] ** -0.5, dtype=COMPUTE_DTYPE, device=q.device)
    qf = (q * scale).to(COMPUTE_DTYPE)
    s = torch.einsum("bqkgd,bckd->bkgqc", qf, k).float()
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & ((qp - kp) < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bkgqd", p.to(COMPUTE_DTYPE), v)
    return out.permute(0, 3, 1, 2, 4).to(COMPUTE_DTYPE)


def attn_apply(p: dict, x, cfg, q_pos, kv_src=None, cache: dict | None = None,
               causal: bool = True, window: int = 0, in_place: bool = False,
               active=None):
    """x (B, S, D), q_pos (B, S). Returns (out (B, S, D), updated cache).

    kv_src (B, Sk, D) or None: cross attention over it (keys at positions
    0..Sk-1, no rotation, never a cache); the caller passes causal=False.
    cache: {"k", "v": (B, size, KV, hd), "pos": (B, size), "len": (B,)} or
    None. Without a cache, and for a prefill (S > 1), the queries and keys
    sit at positions 0..S-1 and attention runs through the kernel; a decode
    step (S == 1) writes slot len % size and attends over the cache.

    in_place (a decode step of a compiled program): the ring write goes
    into the cache's own k, v and pos (index_copy_), which the returned
    cache holds, instead of into copies of them; attention reads the same
    values either way. With ``active`` (B,) bool, an inactive slot's
    entries at the written index are put back after attention (its lane's
    output is garbage by contract, computed as without the mask)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kv
    src = x if kv_src is None else kv_src
    dt = COMPUTE_DTYPE      # weights cast at use (a no-op on stored bf16)
    q = x @ at_use(p["wq"], x)
    kproj = src @ at_use(p["wk"], src)
    vproj = src @ at_use(p["wv"], src)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        kproj = kproj + p["bk"].to(dt)
        vproj = vproj + p["bv"].to(dt)
    q = q.view(b, s, h, hd)
    kproj = kproj.view(b, -1, kv, hd)
    vproj = vproj.view(b, -1, kv, hd)
    if kv_src is not None:
        sk = kproj.shape[1]
        if s <= 8:   # the JAX core's single pass for a few queries
            k_pos = torch.arange(sk, dtype=torch.int32, device=x.device)[None].expand(b, sk)
            out = _single_pass(q.view(b, s, kv, g, hd), kproj, vproj, q_pos, k_pos,
                               causal, window)
        else:
            out = ops.flash_attention(q, kproj, vproj, causal=causal, window=window)
        return out.reshape(b, s, h * hd) @ at_use(p["wo"], out), None
    q = rope(q, q_pos, cfg.rope_theta)
    kproj = rope(kproj, q_pos, cfg.rope_theta)

    if cache is None or s > 1:
        out = ops.flash_attention(q, kproj, vproj, causal=causal, window=window)
        new_cache = None
        if cache is not None:
            new_cache = _prefill_cache(cache, kproj, vproj, q_pos)
    else:
        # decode: a ring-buffer write at len % size (uniform over the batch),
        # then attention over the cache; slot is a device tensor (no sync)
        size = cache["k"].shape[1]
        slot = (cache["len"][:1] % size).long()
        new = (kproj.to(COMPUTE_DTYPE), vproj.to(COMPUTE_DTYPE), q_pos.to(cache["pos"].dtype))
        ring = (cache["k"], cache["v"], cache["pos"])
        if in_place:
            old = [t.index_select(1, slot) for t in ring] if active is not None else None
            k_all, v_all, pos_all = (t.index_copy_(1, slot, n) for t, n in zip(ring, new))
        else:
            k_all, v_all, pos_all = (t.index_copy(1, slot, n) for t, n in zip(ring, new))
        out = _single_pass(q.view(b, s, kv, g, hd), k_all, v_all, q_pos, pos_all,
                           causal, window)
        if in_place and active is not None:
            for t, n, o in zip(ring, new, old):
                keep = active.view(b, *[1] * (n.ndim - 1))
                t.index_copy_(1, slot, torch.where(keep, n, o))
        new_cache = {"k": k_all, "v": v_all, "pos": pos_all, "len": cache["len"] + s}
    return out.reshape(b, s, h * hd) @ at_use(p["wo"], out), new_cache


def _prefill_cache(cache: dict, kproj, vproj, q_pos) -> dict:
    """The cache after a prefill of S tokens: the last `size` of them,
    rolled so position p sits at slot p % size (the decode ring invariant),
    or, when S < size, the first S slots."""
    size = cache["k"].shape[1]
    s = kproj.shape[1]
    k_new, v_new = kproj.to(COMPUTE_DTYPE), vproj.to(COMPUTE_DTYPE)
    pos_new = q_pos.to(cache["pos"].dtype)
    if s >= size:
        shift = (s - size) % size
        k_all = torch.roll(k_new[:, -size:], shift, dims=1)
        v_all = torch.roll(v_new[:, -size:], shift, dims=1)
        pos_all = torch.roll(pos_new[:, -size:], shift, dims=1)
    else:
        k_all = torch.cat([k_new, cache["k"][:, s:]], dim=1)
        v_all = torch.cat([v_new, cache["v"][:, s:]], dim=1)
        pos_all = torch.cat([pos_new, cache["pos"][:, s:]], dim=1)
    return {"k": k_all, "v": v_all, "pos": pos_all, "len": cache["len"] + s}


def make_cache(cfg, batch: int, max_len: int, n_layers: int, window: int = 0,
               device=None) -> dict:
    """Stacked (over layers) KV cache for one attention stage."""
    size = min(window, max_len) if window else max_len
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((n_layers, batch, size, kv, hd), dtype=COMPUTE_DTYPE,
                         device=device),
        "v": torch.zeros((n_layers, batch, size, kv, hd), dtype=COMPUTE_DTYPE,
                         device=device),
        "pos": torch.full((n_layers, batch, size), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((n_layers, batch), dtype=torch.int32, device=device),
    }
