"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Block:  x -> [W_gate -> GeLU] branch (gate)
        x -> [W_x -> causal depthwise conv(w=4) -> RG-LRU] branch
        out = W_out (gate * lru_out)

RG-LRU per channel:
    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A sequence (S > 1) runs the recurrence through ops.rg_lru (the CUDA kernel
on the card, its plain twin on the CPU), the function the JAX package
computes with an associative scan; in a training step its gradient is
the rg_lru backward kernel (ops.rg_lru's autograd). A decode step (S == 1)
is the one-step update. Weights are cast at use (layers.at_use).

Under a tp.TP whose "lru" is split (a mesh's "model" axis), each rank holds
its W/M channels: the columns of w_in, w_gate, conv_w, conv_b and lam, the
rows of w_out (its partial output summed over the group) and the rows of
the float32 gate matrices w_r / w_i ("lru", "lru_out"), whose partial
products over the rank's channels are summed in float32, both gates in one
buffer, before the rank keeps its own columns (tp.TP.reduce_take, whose
backward gathers the columns' cotangents). The input enters the rank's
channels (tp.TP.enter); w_out's partial output is summed (tp.TP.reduce). The recurrence and the
decode states run on the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import COMPUTE_DTYPE, ParamDef, at_use
from repro_torch.models.tp import split

C_EXP = 8.0


def rglru_defs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.rglru_dim or d
    f32 = torch.float32
    return {
        "w_in": ParamDef((d, w), ("embed", "lru")),
        "w_gate": ParamDef((d, w), ("embed", "lru")),
        "conv_w": ParamDef((cfg.conv_width, w), (None, "lru"), scale=0.1),
        "conv_b": ParamDef((w,), ("lru",), init="zeros"),
        "w_r": ParamDef((w, w), ("lru", "lru_out"), dtype=f32),
        "w_i": ParamDef((w, w), ("lru", "lru_out"), dtype=f32),
        "lam": ParamDef((w,), ("lru",), init="ones", dtype=f32),
        "w_out": ParamDef((w, d), ("lru", "embed")),
    }


def _causal_conv(x, w, b, state):
    """Depthwise causal conv, width K, in x's dtype. x: (B, S, W); state:
    (B, K-1, W) of the previous tokens, or None (zeros)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, W)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return out + b.to(x.dtype), new_state


def rglru_apply(p: dict, x, cfg, state: dict | None = None, tp=None):
    """x: (B, S, D). state: {"h": (B, W), "conv": (B, K-1, W)} or None (W:
    this rank's channels under ``tp``). Returns (out (B, S, D), new state or
    None)."""
    lru_split = split(tp, "lru", cfg.rglru_dim or cfg.d_model)
    if lru_split:       # the replicated stream enters the rank's channels
        x = tp.enter(x)
    gate = F.gelu(x @ at_use(p["w_gate"], x), approximate="tanh")
    u = x @ at_use(p["w_in"], x)
    u, conv_state = _causal_conv(u, p["conv_w"], p["conv_b"],
                                 None if state is None else state["conv"])
    uf = u.float()
    # the gates' weights and lam stay float32, as the reference uses them
    if lru_split:
        r, i = tp.reduce_take([uf @ p["w_r"].float(), uf @ p["w_i"].float()])
        r, i = torch.sigmoid(r), torch.sigmoid(i)
    else:
        r = torch.sigmoid(uf @ p["w_r"].float())
        i = torch.sigmoid(uf @ p["w_i"].float())
    # jax.nn.softplus is logaddexp(x, 0), with no linear threshold
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -C_EXP * softplus * r
    scale = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    b = scale * (i * uf)
    if state is None:
        h = ops.rg_lru(log_a, b)
        new_state = None
    else:
        h0 = state["h"].float()
        if x.shape[1] == 1:  # decode: one step
            h = (torch.exp(log_a[:, 0]) * h0 + b[:, 0])[:, None, :]
        else:
            h = ops.rg_lru(log_a, b, h0)
        new_state = {"h": h[:, -1, :].float(), "conv": conv_state}
    y = gate * h.to(COMPUTE_DTYPE)
    out = y @ at_use(p["w_out"], y)
    return (tp.reduce(out) if lru_split else out), new_state


def make_rglru_state(cfg, batch: int, n_layers: int, device=None) -> dict:
    w = cfg.rglru_dim or cfg.d_model
    return {
        "h": torch.zeros((n_layers, batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, w), dtype=COMPUTE_DTYPE,
                            device=device),
    }
