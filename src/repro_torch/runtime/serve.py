"""ECC split-serve: the paper's deployment shape.

The model is cut at the ECC-planned layer s*: layers [0, s) run on the
*device*, layers [s, F) on the *edge*. The two halves are separate programs
(the paper's device and edge are distinct systems joined by a NOMA radio
link); the planner prices the activation transfer with the NOMA rate model
and `transfer_seconds` reports the simulated link time. Both halves run the
same kernels on the same shapes in the same order as Model.forward, so the
split logits equal the unsplit ones to the bit.

The mesh-bound jit_* programs, the masked decode step and the online
server wait for the online slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import Model
from repro_torch.models.layers import COMPUTE_DTYPE, embed_lookup, logits_out


class SplitPrograms(NamedTuple):
    device_fn: Callable   # tokens (B, S) -> activation (B, S, D) bf16
    edge_fn: Callable     # activation (B, S, D) -> logits float32 (B, S, Vp)
    split_layer: int
    act_bytes_per_token: int


def _split_params(model: Model, s: int):
    """The stages of layers [0, s) and of [s, F): (spec, layers) pairs, a
    stage that straddles s cut into two with its ModuleList sliced."""
    a_stages, b_stages = [], []
    seen = 0
    for spec, layers in zip(model.stages, model.stage_layers):
        if seen + spec.n_layers <= s:
            a_stages.append((spec, layers))
        elif seen >= s:
            b_stages.append((spec, layers))
        else:
            cut = s - seen
            a_stages.append((dataclasses.replace(spec, n_layers=cut), layers[:cut]))
            b_stages.append((dataclasses.replace(spec, n_layers=spec.n_layers - cut),
                             layers[cut:]))
        seen += spec.n_layers
    return a_stages, b_stages


def make_split_serve(model: Model, s: int) -> SplitPrograms:
    """Device and edge programs for split point s (decoder-only archs)."""
    if not 0 <= s <= model.cfg.n_layers:
        raise ValueError(f"split point {s} outside [0, {model.cfg.n_layers}]")
    a_stages, b_stages = _split_params(model, s)

    @torch.no_grad()
    def device_fn(tokens):
        b, sl = tokens.shape
        x = embed_lookup(model.top.embed, tokens)
        aux = {"pos": model._positions(b, sl)}
        for spec, layers in a_stages:
            x, _, _ = model._run_stage(spec, layers, x, aux, None)
        return x.to(COMPUTE_DTYPE)

    @torch.no_grad()
    def edge_fn(x):
        b, sl, _ = x.shape
        aux = {"pos": model._positions(b, sl)}
        for spec, layers in b_stages:
            x, _, _ = model._run_stage(spec, layers, x, aux, None)
        x = model._final_norm(x)
        return logits_out(x, model.top.unembed, model.cfg.vocab_size)

    act_bytes = model.cfg.d_model * 2  # bf16 residual stream per token
    return SplitPrograms(device_fn=device_fn, edge_fn=edge_fn, split_layer=s,
                         act_bytes_per_token=act_bytes)


def transfer_seconds(n_tokens: int, d_model: int, rate_bps: float) -> float:
    """Simulated NOMA uplink time for the split activation."""
    bits = n_tokens * d_model * 16
    return bits / max(rate_bps, 1e-9)


def planned_transfer_seconds(env, prof, plan):
    """Per-user split-upload seconds under the *discrete* plan: the NOMA
    uplink rate each user gets on its assigned subchannel at its planned
    power, pricing prof.w[s] bits. The planner-side twin of
    `transfer_seconds`: for an LM profile built at batch=1, w[s] = seq *
    d_model * ACT_BITS, so the two agree on the same rate."""
    from repro_torch.core import channel
    beta_up = F.one_hot(plan.sub_up.long(), env.n_sub).to(env.g_up.dtype)
    r_up = torch.sum(channel.uplink_rates(env, beta_up, plan.p_up), dim=-1)
    bits = prof.w[plan.s]
    return bits / torch.clamp_min(r_up, 1e-9)
