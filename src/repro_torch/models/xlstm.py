"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential) in pre-norm residual blocks.

mLSTM: per head, state C_t = f_t C_{t-1} + i_t v_t k_t^T, n_t = f_t n_{t-1}
+ i_t k_t, out h_t = (C_t q_t) / max(|n_t . q_t|, 1), computed chunkwise
(intra-chunk quadratic + a scan of the state over chunks), with
log-sigmoid forget and clipped log-input gates in float32.

sLSTM: per head scalar-memory LSTM with exponential input gating and a
block-diagonal recurrent matrix, run step by step over time.

The JAX package's lax.scan over chunks and over time are Python loops over
tensors here; no Pallas kernel exists for either.

Heads over a mesh's "model" axis (a tp.TP): where M divides H, a rank's
columns of wq / wk / wv / wo_gate, wi / wf, w_zifo / b_zifo (zifo is
(h, 4hd), head-major) and its slices of r_zifo are whole heads, and it
runs its heads' chunk scan and sLSTM loop (r_zifo is block-diagonal per
head: no collective inside the time loop); wo / w_out are row-parallel,
one all-reduce. Where the projections split but cut heads (H does not
divide, h * hd does), the rank gathers them whole and runs every head,
and multiplies its columns of the output by its rows of wo / w_out.
The caches keep the reference's layout, each state split over "model" on
its last dim (hd) where that divides (runtime.sharding.cache_shardings):
a call assembles the heads it runs from that layout at its start and
cuts its new states back to it at its end (_heads_in / _heads_out), one
all-reduce each way a state leaf where the layouts differ. A training
forward carries no state, so neither runs there.

Training on the mesh (tp.TP's autograd Functions): the input enters the
rank's work where a projection splits (tp.enter), and the row-parallel
output is summed by tp.reduce. Where heads are cut, each gathered
projection enters again: every rank runs every head but keeps only its
columns, so the whole wi / wf (mLSTM) and r_zifo (sLSTM) get per-rank
partial gradients (PARTIAL in Model.grad_kinds); where the heads split
they split with them.

The chunk math and the whole sLSTM recurrence stay float32, as in the
reference, and so do the gate weights (wi, wf, w_zifo, b_zifo, r_zifo),
which the reference never rounds to bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import COMPUTE_DTYPE, ParamDef
from repro_torch.models.tp import split

CHUNK = 256


def _heads(cfg, tp) -> tuple[bool, bool]:
    """(heads split, h * hd projections split) under ``tp``: each leaf's own
    placement."""
    return split(tp, "heads", cfg.n_heads), split(tp, "qkv", cfg.n_heads * cfg.hd)


def _heads_in(state: dict, tp, heads_split: bool) -> dict:
    """State leaves (B, H, ..., hd / M or hd) in the cache's layout as the
    heads this rank runs, whole on hd: a leaf is gathered over hd where the
    cache splits it (tp.state_split, the leaf's placement), then cut to this
    rank's heads where it runs its own."""
    out = {}
    for key, t in state.items():
        if tp.state_split[key]:
            t = tp.gather(t, -1)
        out[key] = tp.take(t, 1) if heads_split else t
    return out


def _heads_out(state: dict, tp, heads_split: bool) -> dict:
    """The inverse of _heads_in: new states of the heads this rank ran, in
    the cache's layout."""
    out = {}
    for key, t in state.items():
        if heads_split:
            t = tp.gather(t, 1)
        out[key] = tp.take(t, -1) if tp.state_split[key] else t
    return out


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def mlstm_defs(cfg) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    f32 = torch.float32
    return {
        "wq": ParamDef((d, h * hd), ("embed", "qkv")),
        "wk": ParamDef((d, h * hd), ("embed", "qkv")),
        "wv": ParamDef((d, h * hd), ("embed", "qkv")),
        "wi": ParamDef((d, h), ("embed", "heads"), dtype=f32),
        "wf": ParamDef((d, h), ("embed", "heads"), dtype=f32),
        "wo_gate": ParamDef((d, h * hd), ("embed", "qkv")),
        "wo": ParamDef((h * hd, d), ("qkv", "embed")),
    }


def _mlstm_chunk_scan(q, k, v, log_f, log_i, state):
    """q, k, v: (B, H, S, hd); log_f, log_i: (B, H, S) float32.
    state: (C0 (B, H, hd, hd), n0 (B, H, hd)) or None. Returns (out float32
    (B, H, S, hd), (C, n))."""
    b, h, s, hd = q.shape
    c = min(CHUNK, s)
    nc = s // c
    assert s % c == 0, f"seq {s} must divide chunk {c}"
    scale = hd ** -0.5
    if state is None:
        C = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=q.device)
        n = torch.zeros((b, h, hd), dtype=torch.float32, device=q.device)
    else:
        C, n = state
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    outs = []
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        qf, kf, vf = (t[:, :, sl].float() for t in (q, k, v))
        lfb, lib = log_f[:, :, sl].float(), log_i[:, :, sl].float()
        cum = torch.cumsum(lfb, dim=-1)                 # (b,h,c) inclusive
        tot = cum[..., -1:]
        # intra-chunk: D[i,j] = exp(cum_i - cum_j + li_j) for i >= j
        dmat = cum[..., :, None] - cum[..., None, :] + lib[..., None, :]
        dmat = torch.where(mask, dmat, -torch.inf)
        scores = torch.einsum("bhid,bhjd->bhij", qf, kf) * scale
        w = scores * torch.exp(dmat)
        intra = torch.einsum("bhij,bhjd->bhid", w, vf)
        # inter-chunk: decayed initial state
        dec_q = torch.exp(cum)[..., None]               # (b,h,c,1)
        inter = torch.einsum("bhid,bhde->bhie", qf * dec_q, C) * scale
        # normalizer q . n_t, split the same way (intra = row-sum of w)
        n_inter = torch.einsum("bhid,bhd->bhi", qf * dec_q, n) * scale
        n_intra_q = torch.sum(w, dim=-1)
        den = torch.clamp_min(torch.abs(n_inter + n_intra_q), 1.0)[..., None]
        outs.append((intra + inter) / den)
        # state update: C' = exp(tot) C + sum_j exp(tot - cum_j + li_j) k_j v_j^T
        decay_j = torch.exp(tot - cum + lib)[..., None]  # (b,h,c,1)
        C = torch.exp(tot)[..., None] * C + torch.einsum("bhjd,bhje->bhde",
                                                         kf * decay_j, vf)
        n = torch.exp(tot[..., 0])[..., None] * n + torch.sum(kf * decay_j, dim=2)
    return torch.cat(outs, dim=2), (C, n)


def mlstm_apply(p: dict, x, cfg, state: dict | None = None, tp=None):
    """x: (B, S, D). state: {"C": (B, H, hd, hd), "n": (B, H, hd)} or None
    (on a mesh, the cache's shard: module docstring). Returns (out (B, S, D),
    new state or None)."""
    b, s, d = x.shape
    hd = cfg.hd
    dt = COMPUTE_DTYPE
    heads_split, qkv_split = _heads(cfg, tp)
    gather = qkv_split and not heads_split       # a split that cuts heads
    if qkv_split:           # the replicated stream enters the rank's work
        x = tp.enter(x)

    def heads(w):
        y = x @ w.to(dt)
        if gather:          # made whole, then used for the rank's columns only
            y = tp.enter(tp.gather_cols(y))
        return y.view(b, s, -1, hd).transpose(1, 2)

    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    h = q.shape[1]                               # the heads this rank runs
    xf = x.float()
    log_i = torch.clamp(xf @ p["wi"].float(), -10.0, 5.0).transpose(1, 2)
    log_f = F.logsigmoid(xf @ p["wf"].float() + 3.0).transpose(1, 2)
    if state is not None and tp is not None:
        state = _heads_in(state, tp, heads_split)

    if state is not None and s == 1:
        # decode: single recurrent update
        C, n = state["C"], state["n"]
        f = torch.exp(log_f[..., 0])[..., None, None]
        i = torch.exp(log_i[..., 0])[..., None, None]
        kk = k[:, :, 0].float()
        vv = v[:, :, 0].float()
        Cn = f * C + i * torch.einsum("bhd,bhe->bhde", kk, vv)
        nn = f[..., 0] * n + i[..., 0] * kk
        qq = q[:, :, 0].float() * (hd ** -0.5)
        num = torch.einsum("bhd,bhde->bhe", qq, Cn)
        den = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", qq, nn)), 1.0)
        out = (num / den[..., None])[:, :, None, :]
        new_state = {"C": Cn, "n": nn}
    else:
        st = None if state is None else (state["C"], state["n"])
        out, (cN, nN) = _mlstm_chunk_scan(q, k, v, log_f, log_i, st)
        new_state = None if state is None else {"C": cN, "n": nN}
    if new_state is not None and tp is not None:
        new_state = _heads_out(new_state, tp, heads_split)

    out = out.transpose(1, 2).reshape(b, s, h * hd).to(dt)
    if gather:      # this rank's columns: its rows of wo
        out = tp.take(out, -1)
    gate = F.silu(x @ p["wo_gate"].to(dt))
    y = (out * gate) @ p["wo"].to(dt)
    return (tp.reduce(y) if qkv_split else y), new_state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def slstm_defs(cfg) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    f32 = torch.float32
    return {
        "w_zifo": ParamDef((d, 4 * h * hd), ("embed", "qkv"), dtype=f32),
        "r_zifo": ParamDef((h, hd, 4 * hd), ("heads", None, None), scale=0.05, dtype=f32),
        "b_zifo": ParamDef((4 * h * hd,), ("qkv",), init="zeros", dtype=f32),
        "w_out": ParamDef((h * hd, d), ("qkv", "embed")),
    }


def slstm_apply(p: dict, x, cfg, state: dict | None = None, tp=None):
    """Sequential loop over time. state: {"c", "n", "h", "m": (B, H, hd)}
    or None (on a mesh, the cache's shard: module docstring). Returns (out
    (B, S, D), new state or None)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    heads_split, out_split = _heads(cfg, tp)
    z_split = split(tp, "qkv", 4 * h * hd)
    if z_split:             # the replicated stream enters the rank's columns
        x = tp.enter(x)
    zifo = x.float() @ p["w_zifo"].float() + p["b_zifo"].float()
    if z_split and not heads_split:     # a split that cuts heads
        zifo = tp.gather_cols(zifo)
        if out_split:       # every head run, the rank's columns kept
            zifo = tp.enter(zifo)
    zifo = zifo.view(b, s, -1, 4 * hd)
    h = zifo.shape[2]                            # the heads this rank runs

    if state is None:
        c = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros_like(c)
        hh = torch.zeros_like(c)
        m = torch.full_like(c, -1e30)
    else:
        if tp is not None:
            state = _heads_in(state, tp, heads_split)
        c, n, hh, m = state["c"], state["n"], state["h"], state["m"]

    r = p["r_zifo"].float()
    outs = []
    for t in range(s):
        rec = torch.bmm(hh.transpose(0, 1), r).transpose(0, 1)   # (B, H, 4hd)
        g = zifo[:, t] + rec
        zt, it, ft, ot = torch.split(g, hd, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        # exponential gating with stabilizer m
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(log_f + m - m_new)
        c = f_s * c + i_s * zt
        n = f_s * n + i_s
        hh = ot * c / torch.clamp_min(torch.abs(n), 1.0)
        m = m_new
        outs.append(hh)
    out = torch.stack(outs, dim=1).reshape(b, s, h * hd).to(COMPUTE_DTYPE)
    new_state = None if state is None else {"c": c, "n": n, "h": hh, "m": m}
    if new_state is not None and tp is not None:
        new_state = _heads_out(new_state, tp, heads_split)
    if out_split and not heads_split:    # this rank's columns: its rows of w_out
        out = tp.take(out, -1)
    y = out @ p["w_out"].to(COMPUTE_DTYPE)
    return (tp.reduce(y) if out_split else y), new_state


def make_xlstm_state(cfg, batch: int, n_m: int, n_s: int, device=None) -> dict:
    h, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    return {
        "mlstm": {
            "C": torch.zeros((n_m, batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((n_m, batch, h, hd), dtype=f32, device=device),
        },
        "slstm": {
            "c": torch.zeros((n_s, batch, h, hd), dtype=f32, device=device),
            "n": torch.zeros((n_s, batch, h, hd), dtype=f32, device=device),
            "h": torch.zeros((n_s, batch, h, hd), dtype=f32, device=device),
            "m": torch.full((n_s, batch, h, hd), -1e30, dtype=f32, device=device),
        },
    }
