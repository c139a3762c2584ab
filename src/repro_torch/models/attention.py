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
decode step) through the single-pass path, as the JAX core splits them; in
the flat layout K and V are repeated once a query head, as for self
attention, and it has no cache in either layout.

Two layouts, as the JAX package's Model(cfg, tp_size=M) chooses them
(cfg.attn_layout): "grouped" keeps q as KV groups of G query heads; "flat"
pads the query heads to Hp (a multiple of M), repeats K and V once a query
head (head_map) and attends at G = 1, the padded heads zeroed. Under a
tp.TP (a mesh's "model" axis) each rank holds its columns of wq / wk / wv
and its rows of wo, as the specs place them: grouped, its KV/M kv heads and
their query heads; flat, its Hp/M query heads, with K and V gathered whole
when wk / wv split inside a head. wo's partial output is summed over the
group. Cross attention runs the same shards over its source, which every
rank holds whole. Decode always runs the grouped math over the cache: a
cache split by kv heads (grouped) attends locally; a cache whose sequence
is split over the group (flat, its size a multiple of M) takes the
gathered queries, runs the single pass over the rank's slots and merges
the ranks' partial softmaxes (tp.TP.lse_combine: flash-decoding across
ranks).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import COMPUTE_DTYPE, ParamDef, at_use, rope
from repro_torch.models.tp import split

NEG_INF = -1e30


def attn_defs(cfg, cross: bool = False) -> dict:
    d, kv, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    h = _query_heads(cfg)
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


def _query_heads(cfg) -> int:
    """The query heads the projections hold: H, or the flat layout's Hp."""
    if cfg.attn_layout == "flat":
        return cfg.heads_padded or cfg.n_heads
    return cfg.n_heads


def _scores(q, k, q_pos, k_pos, causal: bool, window: int):
    """Scaled scores (B, KV, G, Sq, Sk) float32 of q (B, Sq, KV, G, hd) over
    k (B, Sk, KV, hd), and the mask of the keys each query may see."""
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
    return s, valid


def _single_pass(q, k, v, q_pos, k_pos, causal: bool, window: int):
    """Attention of a few queries over a cache in one pass (the JAX
    package's decode path): q (B, Sq, KV, G, hd) pre-scaled in bf16, k/v
    (B, Sk, KV, hd), slots with k_pos < 0 empty. Returns (B, Sq, KV, G, hd).
    The scale is rounded to bf16 before the product, as JAX rounds a
    Python float that multiplies a bf16 array (a fill, not a copy from the
    host: a CUDA graph may capture this)."""
    s, valid = _scores(q, k, q_pos, k_pos, causal, window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckd->bkgqd", p.to(COMPUTE_DTYPE), v)
    return out.permute(0, 3, 1, 2, 4).to(COMPUTE_DTYPE)


def _split_pass(q, k, v, q_pos, k_pos, causal: bool, window: int, tp):
    """_single_pass over keys split across tp's group (each rank its slots
    of the cache): each rank's partial max, sum and float32 output,
    merged by tp.lse_combine. Returns (B, Sq, KV, G, hd)."""
    s, valid = _scores(q, k, q_pos, k_pos, causal, window)
    m = torch.where(valid, s, NEG_INF).amax(-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bkgqc,bckd->bkgqd", p, v.float())
    out = tp.lse_combine(m, p.sum(-1), acc)
    return out.permute(0, 3, 1, 2, 4).to(COMPUTE_DTYPE)


def attn_apply(p: dict, x, cfg, q_pos, kv_src=None, cache: dict | None = None,
               causal: bool = True, window: int = 0, in_place: bool = False,
               active=None, tp=None, max_len: int | None = None):
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
    output is garbage by contract, computed as without the mask).

    tp (a tp.TP) runs this rank's shard (module docstring); a cache of the
    flat layout then holds the rank's slots of a ring of size
    min(window, max_len) (or max_len) when that divides over the group,
    which is how ``max_len`` is read."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kv
    flat = cfg.attn_layout == "flat"
    src = x if kv_src is None else kv_src
    dt = COMPUTE_DTYPE      # weights cast at use (a no-op on stored bf16)
    q = x @ at_use(p["wq"], x)
    kproj = src @ at_use(p["wk"], src)
    vproj = src @ at_use(p["wv"], src)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        kproj = kproj + p["bk"].to(dt)
        vproj = vproj + p["bv"].to(dt)
    if flat and split(tp, "kv", kv * hd):   # split inside a head
        kproj, vproj = tp.gather_cols(kproj), tp.gather_cols(vproj)
    qkv_split = split(tp, "qkv", _query_heads(cfg) * hd)
    hq_l, kv_l = q.shape[-1] // hd, kproj.shape[-1] // hd     # this rank's heads
    h0 = tp.offset(hq_l) if qkv_split else 0
    q = q.view(b, s, hq_l, hd)
    kproj = kproj.view(b, -1, kv_l, hd)
    vproj = vproj.view(b, -1, kv_l, hd)
    if kv_src is not None:
        out = _cross(q, kproj, vproj, q_pos, flat, h0, cfg, causal, window)
        out = out.reshape(b, s, hq_l * hd) @ at_use(p["wo"], out)
        return (tp.all_reduce_sum(out) if qkv_split else out), None
    q = rope(q, q_pos, cfg.rope_theta)
    kproj = rope(kproj, q_pos, cfg.rope_theta)
    seq = _seq_split(cfg, cache, tp, window, max_len) if flat else None

    if cache is None or s > 1:
        if flat:    # K / V repeated once a query head of this rank's: G = 1
            heads = h0 + torch.arange(hq_l, device=x.device)
            head_map = torch.clamp(heads // g, 0, kv - 1)
            out = ops.flash_attention(q, kproj[:, :, head_map], vproj[:, :, head_map],
                                      causal=causal, window=window)
            if _padded(cfg):    # the padded heads' random wq / wo must not leak
                out = out * (heads < h).to(out.dtype)[:, None]
        else:
            out = ops.flash_attention(q, kproj, vproj, causal=causal, window=window)
        new_cache = None
        if cache is not None:
            new_cache = _prefill_cache(cache, kproj, vproj, q_pos, seq)
    else:
        # decode: a ring-buffer write at len % size (uniform over the batch),
        # then attention over the cache; slot is a device tensor (no sync).
        # A sequence split over the group: the rank that holds the slot
        # writes it, the others write back what they hold.
        size = cache["k"].shape[1]
        ring = (cache["k"], cache["v"], cache["pos"])
        new = (kproj.to(COMPUTE_DTYPE), vproj.to(COMPUTE_DTYPE), q_pos.to(cache["pos"].dtype))
        if seq is None:
            slot = (cache["len"][:1] % size).long()
        else:
            at = (cache["len"][:1] % (size * seq.size)).long()
            slot = at % size
            mine = (at // size) == seq.rank
        old = ([t.index_select(1, slot) for t in ring]
               if (in_place and active is not None) or seq is not None else None)
        if seq is not None:
            new = tuple(torch.where(mine.view(-1, *[1] * (n.ndim - 1)), n, o)
                        for n, o in zip(new, old))
        if in_place:
            k_all, v_all, pos_all = (t.index_copy_(1, slot, n) for t, n in zip(ring, new))
        else:
            k_all, v_all, pos_all = (t.index_copy(1, slot, n) for t, n in zip(ring, new))
        if flat:    # the grouped math over every query head
            q_g = q.reshape(b, s, hq_l * hd)
            if qkv_split:
                q_g = tp.gather_cols(q_g)
            q_g = q_g[..., :h * hd].view(b, s, kv, g, hd)
            attend = _single_pass if seq is None else (
                lambda *a: _split_pass(*a, seq))
            out = attend(q_g, k_all, v_all, q_pos, pos_all, causal, window)
            out = out.reshape(b, s, h, hd)
            if _padded(cfg):
                out = torch.cat([out, out.new_zeros((b, s, _query_heads(cfg) - h, hd))], 2)
            out = out[:, :, h0:h0 + hq_l]
        else:
            out = _single_pass(q.view(b, s, kv_l, hq_l // kv_l, hd), k_all, v_all, q_pos,
                               pos_all, causal, window)
        if in_place and active is not None:
            for t, n, o in zip(ring, new, old):
                keep = active.view(b, *[1] * (n.ndim - 1))
                t.index_copy_(1, slot, torch.where(keep, n, o))
        new_cache = {"k": k_all, "v": v_all, "pos": pos_all, "len": cache["len"] + s}
    out = out.reshape(b, s, hq_l * hd) @ at_use(p["wo"], out)
    if qkv_split:
        out = tp.all_reduce_sum(out)
    return out, new_cache


def _cross(q, k, v, q_pos, flat: bool, h0: int, cfg, causal: bool, window: int):
    """Cross attention of q (B, S, Hq, hd) (this rank's query heads, the
    first global head h0) over k / v (B, Sk, KV, hd) (its KV heads, or all
    of them in the flat layout): keys at 0..Sk-1 (the callers pass causal
    False, no window). The flat layout repeats K / V once a query head (the
    reference's head_map) and zeroes the padded heads. A few queries (a decode step) take the single pass,
    more the kernel, as the JAX core splits them. Returns (B, S, Hq, hd)."""
    b, s, hq, hd = q.shape
    h, kv = cfg.n_heads, cfg.n_kv_heads
    if flat:
        heads = h0 + torch.arange(hq, device=q.device)
        head_map = torch.clamp(heads // (h // kv), 0, kv - 1)
        k, v = k[:, :, head_map], v[:, :, head_map]
    sk, kv_l = k.shape[1], k.shape[2]
    if s <= 8:
        k_pos = torch.arange(sk, dtype=torch.int32, device=q.device)[None].expand(b, sk)
        out = _single_pass(q.view(b, s, kv_l, hq // kv_l, hd), k, v, q_pos, k_pos, causal,
                           window)
        out = out.reshape(b, s, hq, hd)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    if flat and _padded(cfg):
        out = out * (heads < h).to(out.dtype)[:, None]
    return out


def _padded(cfg) -> bool:
    return _query_heads(cfg) != cfg.n_heads


def _seq_split(cfg, cache, tp, window: int, max_len):
    """The tp.TP whose group splits this flat-layout cache's sequence (a
    ring of min(window, max_len), or max_len, slots that divides over it:
    runtime.sharding.cache_shardings), or None (no tp, no cache, or the
    cache is whole on every rank)."""
    if tp is None or cache is None or tp.size == 1:
        return None
    if max_len is None:
        raise ValueError("a flat-layout cache on a model axis needs max_len (its ring "
                         "size decides whether its sequence is split)")
    size = min(window, max_len) if window else max_len
    return tp if size % tp.size == 0 else None


def _prefill_cache(cache: dict, kproj, vproj, q_pos, split=None) -> dict:
    """The cache after a prefill of S tokens: the last `size` of them,
    rolled so position p sits at slot p % size (the decode ring invariant),
    or, when S < size, the first S slots. With ``split`` (a tp.TP), the
    cache holds this rank's share of a ring split over the group: its
    slots of the same result."""
    size = cache["k"].shape[1]
    s = kproj.shape[1]
    k_new, v_new = kproj.to(COMPUTE_DTYPE), vproj.to(COMPUTE_DTYPE)
    pos_new = q_pos.to(cache["pos"].dtype)
    if split is not None:
        whole = size * split.size
        lo = split.offset(size)
        if s >= whole:
            shift = (s - whole) % whole
            take = [torch.roll(t[:, -whole:], shift, dims=1)[:, lo:lo + size]
                    for t in (k_new, v_new, pos_new)]
        else:
            idx = lo + torch.arange(size, device=k_new.device)
            filled = idx < s
            take = [torch.where(filled.view(1, -1, *[1] * (t.ndim - 2)),
                                t[:, idx.clamp(max=s - 1)], c)
                    for t, c in zip((k_new, v_new, pos_new),
                                    (cache["k"], cache["v"], cache["pos"]))]
        return {"k": take[0], "v": take[1], "pos": take[2], "len": cache["len"] + s}
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
