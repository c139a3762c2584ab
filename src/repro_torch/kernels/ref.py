"""Plain PyTorch oracles, float32: naive softmax attention, the RG-LRU
recurrence as a log-depth scan, and the NOMA pairwise reduction (the
allclose targets the kernels and their compositions are held against)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, group: int, causal=True, window=0,
                        kv_len=None):
    """q: (B*KV*G, Sq, hd); k/v: (B*KV, Sk, hd). Naive softmax attention
    over positions 0..Sq-1 and 0..Sk-1, in float32, cast to q's dtype."""
    sq, hd = q.shape[1], q.shape[2]
    sk = k.shape[1]
    kv_len = sk if kv_len is None else kv_len
    k = torch.repeat_interleave(k.float(), group, dim=0)
    v = torch.repeat_interleave(v.float(), group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k) * hd**-0.5
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos < kv_len
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype)


def rg_lru_ref(log_a, b, h0=None):
    """h_t = exp(log_a_t) * h_{t-1} + b_t by a log-depth (Hillis-Steele)
    scan over S: the composition of two steps (a1, b1) then (a2, b2) is
    (a1 a2, a2 b1 + b2). log_a, b: (B, S, W) float32; h0: (B, W)."""
    a = torch.exp(log_a.float())
    bb = b.float().clone()
    if h0 is not None:
        bb[:, 0] += a[:, 0] * h0.float()
    shift = 1
    while shift < a.shape[1]:
        a_prev = torch.ones_like(a)
        b_prev = torch.zeros_like(bb)
        a_prev[:, shift:] = a[:, :-shift]
        b_prev[:, shift:] = bb[:, :-shift]
        bb = a * b_prev + bb
        a = a * a_prev
        shift *= 2
    return bb


def _cmp(own_u, own_v, descending: bool):
    if descending:
        return own_v[None, :, :] < own_u[:, None, :]       # (U, V, M)
    return own_v[None, :, :] > own_u[:, None, :]


def noma_pairwise_ref(own_u, own_v, w_intra, w_power, g_vu, same_cell,
                      descending: bool):
    """Oracle for the NOMA pairwise-interference reduction.

    own_u: (U, M)    own-cell gain of each receiver user per subchannel
    own_v: (V, M)    own-cell gain of each interferer
    w_intra: (V, M)  intra-cell contribution of v if selected (beta*p*own_v)
    w_power: (V, M)  tx power weight of v (beta*p), for the inter-cell term
    g_vu: (V, U, M)  gain of interferer v at user u's AP
    same_cell: (U, V) bool
    descending: True -> uplink SIC (weaker own-gain interferes with me);
                False -> downlink SIC (stronger own-gain interferes)
    Returns (intra (U, M), inter (U, M)):
      intra[u,m] = sum_v same[u,v] * cmp(v,u) * w_intra[v,m]
      inter[u,m] = sum_v !same[u,v] * w_power[v,m] * g_vu[v,u,m]
    """
    keep = _cmp(own_u, own_v, descending) & same_cell[:, :, None]
    intra = torch.where(keep, w_intra[None, :, :], 0.0).sum(1)
    inter = torch.einsum("uv,vm,vum->um", (~same_cell).to(w_power.dtype),
                         w_power, g_vu)
    return intra, inter


def noma_pairwise_gather_free_ref(own_u, own_v, w_intra, w_power, g_raw, ap,
                                  descending: bool, uplink: bool):
    """Oracle for the gather-free kernel signature: the same math from the
    raw channel state and the AP ids.

    g_raw: uplink (V, N, M) raw g_up; downlink (N, U, M) raw g_dn
    ap: (U,) int32 serving-AP ids (U == V: interferers are the same users)
    """
    n_aps = g_raw.shape[1] if uplink else g_raw.shape[0]
    oh = torch.nn.functional.one_hot(ap.long(), n_aps).to(w_power.dtype)  # (U, N)
    same = ap[:, None] == ap[None, :]
    keep = _cmp(own_u, own_v, descending) & same[:, :, None]
    intra = torch.where(keep, w_intra[None, :, :], 0.0).sum(1)
    if uplink:
        per_ap = torch.einsum("vn,vm,vnm->nm", 1.0 - oh, w_power, g_raw)
        inter = torch.einsum("un,nm->um", oh, per_ap)
    else:
        ap_tx = torch.einsum("vn,vm->nm", oh, w_power)
        inter = torch.einsum("un,num,nm->um", 1.0 - oh, g_raw, ap_tx)
    return intra, inter


def noma_cell_block_ref(own_u, own_v, w_intra, w_power, g_raw, ap,
                        tile_u, tile_v, block_u: int, block_v: int,
                        descending: bool, uplink: bool):
    """Oracle for the cell-block schedule: the intra term accumulated only
    over the given (tile_u, tile_v) block list, tile by tile, so comparing
    it with noma_pairwise_gather_free_ref proves the list covers every
    same-cell pair exactly once. Inputs are in the sorted user domain when
    the tiles came from a CellLayout."""
    u, m = own_u.shape
    v = own_v.shape[0]
    intra = torch.zeros((u, m), dtype=torch.float32, device=own_u.device)
    same = ap[:, None] == ap[None, :]
    keep_full = _cmp(own_u, own_v, descending) & same[:, :, None]
    for ub, vb in zip(torch.as_tensor(tile_u).tolist(),
                      torch.as_tensor(tile_v).tolist()):
        r0, r1 = ub * block_u, min((ub + 1) * block_u, u)
        s0, s1 = vb * block_v, min((vb + 1) * block_v, v)
        intra[r0:r1] += torch.where(keep_full[r0:r1, s0:s1],
                                    w_intra[None, s0:s1, :], 0.0).sum(1)
    _, inter = noma_pairwise_gather_free_ref(
        own_u, own_v, w_intra, w_power, g_raw, ap, descending=descending,
        uplink=uplink)
    return intra, inter
