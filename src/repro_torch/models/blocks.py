"""Residual blocks: one param-def + apply pair per block kind.

Kinds:
  attn    pre-norm GQA self-attention + MLP (optionally MoE, optionally
          local-window)
  cross   cross-attention block over the frontend, its residual gated by
          tanh(xgate) (the VLM's image layers)
  enc     bidirectional attention + MLP, LayerNorm (whisper encoder)
  dec     causal self-attn + cross-attn over the frontend + MLP, LayerNorm
          (whisper decoder)
  rec     RG-LRU temporal-mixing block + MLP (recurrentgemma)
  mlstm / slstm   xLSTM blocks
and stage lists for every family. The audio family's norms are LayerNorms
(weight ones, bias zeros); every other family's are Gemma RMSNorms.

block_apply(cfg, spec, p, x, aux, cache) -> (x, new_cache, aux_loss)
`aux` carries {"pos": (B, S), "frontend": (B, Sf, D) or None} and, for MoE
blocks, "moe_impl" and "moe_capacity" (defaults "sorted" and 1.25, the
reference's); a compiled decode step adds "in_place" and "active"
(attention.attn_apply); "recompute" marks a block's remat recompute in the
backward (its MoE drops are not logged again). A model on a mesh's
"model" axis adds "tp" (a tp.TP: every mixer, the self and cross
attention, the RG-LRU, the mLSTM and sLSTM heads, the MLP and the MoE
experts, runs this rank's shard on a replicated residual stream with
replicated norms and gates, each summing its partial output once) and
"max_len" (its caches' length, which the flat layout's cache split reads).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention, moe, recurrent, xlstm
from repro_torch.models.layers import ParamDef, layer_norm, mlp_apply, mlp_defs, rms_norm


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str
    n_layers: int
    moe: bool = False
    window: int = 0
    causal: bool = True
    cache: str | None = "kv"     # kv | rglru | mlstm | slstm | None


def _norm_defs(cfg, name):
    f32 = torch.float32
    if cfg.family == "audio":
        return {f"{name}_w": ParamDef((cfg.d_model,), ("embed",), init="ones", dtype=f32),
                f"{name}_b": ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=f32)}
    return {f"{name}_w": ParamDef((cfg.d_model,), ("embed",), init="zeros", dtype=f32)}


def _norm(cfg, p, name, x):
    if cfg.family == "audio":
        return layer_norm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.norm_eps)
    return rms_norm(x, p[f"{name}_w"], cfg.norm_eps)


def block_defs(cfg, spec: StageSpec) -> dict:
    if spec.kind not in ("attn", "enc", "dec", "cross", "rec", "mlstm", "slstm"):
        raise ValueError(spec.kind)
    d: dict = _norm_defs(cfg, "ln1")
    if spec.kind in ("mlstm", "slstm"):
        d[spec.kind] = (xlstm.mlstm_defs if spec.kind == "mlstm" else xlstm.slstm_defs)(cfg)
        return d
    if spec.kind == "cross":
        d["xattn"] = attention.attn_defs(cfg, cross=True)
        # float32, as the reference casts it at use
        d["xgate"] = ParamDef((1,), (None,), init="zeros", dtype=torch.float32)
    elif spec.kind == "rec":
        d["rglru"] = recurrent.rglru_defs(cfg)
    else:
        d["attn"] = attention.attn_defs(cfg)
        if spec.kind == "dec":
            d.update(_norm_defs(cfg, "lnx"))
            d["xattn"] = attention.attn_defs(cfg, cross=True)
    d.update(_norm_defs(cfg, "ln2"))
    if spec.moe:
        d["moe"] = moe.moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.act)
    return d


def block_apply(cfg, spec: StageSpec, p: dict, x, aux: dict, cache=None):
    """Returns (x, new_cache, aux_loss); aux_loss is 0 but for MoE blocks."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    tp = aux.get("tp")
    if spec.kind in ("mlstm", "slstm"):
        apply = xlstm.mlstm_apply if spec.kind == "mlstm" else xlstm.slstm_apply
        h, st = apply(p[spec.kind], _norm(cfg, p, "ln1", x), cfg,
                      state=None if cache is None else cache.get(spec.kind), tp=tp)
        return x + h, (None if st is None else {spec.kind: st}), zero
    if spec.kind == "cross":
        hx, _ = attention.attn_apply(p["xattn"], _norm(cfg, p, "ln1", x), cfg, aux["pos"],
                                     kv_src=aux.get("frontend"), causal=False, tp=tp)
        # the gate multiplies the summed output: xgate is replicated
        x = x + torch.tanh(p["xgate"].float()).to(x.dtype) * hx
        y = mlp_apply(p["mlp"], _norm(cfg, p, "ln2", x), cfg.act, cfg.d_ff, tp)
        return x + y, None, zero     # a cross stage holds no cache
    if spec.kind == "rec":
        h, st = recurrent.rglru_apply(
            p["rglru"], _norm(cfg, p, "ln1", x), cfg,
            state=None if cache is None else cache.get("rglru"), tp=tp)
        new_cache = None if st is None else {"rglru": st}
    else:
        h, kv_cache = attention.attn_apply(
            p["attn"], _norm(cfg, p, "ln1", x), cfg, aux["pos"],
            cache=None if cache is None else cache.get("kv"),
            causal=spec.causal, window=spec.window,
            in_place=aux.get("in_place", False), active=aux.get("active"),
            tp=tp, max_len=aux.get("max_len"))
        new_cache = None if kv_cache is None else {"kv": kv_cache}
    x = x + h
    if spec.kind == "dec":
        hx, _ = attention.attn_apply(p["xattn"], _norm(cfg, p, "lnx", x), cfg, aux["pos"],
                                     kv_src=aux.get("frontend"), causal=False, tp=tp)
        x = x + hx
    if spec.moe:
        y, aux_l = moe.moe_apply(p["moe"], _norm(cfg, p, "ln2", x), cfg,
                                 impl=aux.get("moe_impl", "sorted"),
                                 capacity_factor=aux.get("moe_capacity", 1.25),
                                 log=not aux.get("recompute", False), tp=tp)
        return x + y, new_cache, aux_l
    return (x + mlp_apply(p["mlp"], _norm(cfg, p, "ln2", x), cfg.act, cfg.d_ff, tp),
            new_cache, zero)


def _grouped(specs) -> list[StageSpec]:
    """Consecutive specs of one kind merged into one stage."""
    stages: list[StageSpec] = []
    for spec in specs:
        if stages and stages[-1].kind == spec.kind:
            stages[-1] = dataclasses.replace(stages[-1], n_layers=stages[-1].n_layers + 1)
        else:
            stages.append(spec)
    return stages


def stages_for(cfg) -> list[StageSpec]:
    """The stage list (consecutive same-kind blocks grouped) that realizes
    the architecture's topology."""
    fam = cfg.family
    if fam == "dense":
        return [StageSpec("attn", cfg.n_layers)]
    if fam == "moe":
        stages = []
        if cfg.first_dense_layers:
            stages.append(StageSpec("attn", cfg.first_dense_layers, moe=False))
        stages.append(StageSpec("attn", cfg.n_layers - cfg.first_dense_layers, moe=True))
        return stages
    if fam == "vlm":
        # every cross_attn_every-th layer is a cross block after the group's
        # self-attention layers
        n_cross = cfg.n_layers // cfg.cross_attn_every
        n_self = cfg.n_layers - n_cross
        stages, done = [], 0
        for _ in range(n_cross):
            take = min(cfg.cross_attn_every - 1, n_self - done)
            if take:
                stages.append(StageSpec("attn", take))
                done += take
            stages.append(StageSpec("cross", 1, cache=None))
        if done < n_self:
            stages.append(StageSpec("attn", n_self - done))
        return stages
    if fam == "audio":
        return [StageSpec("enc", cfg.encoder_layers, causal=False, cache=None),
                StageSpec("dec", cfg.n_layers)]
    if fam not in ("hybrid", "ssm"):
        raise ValueError(fam)
    # tile block_pattern (e.g. rec,rec,attn) over depth, grouping runs
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    if fam == "hybrid":
        return _grouped(StageSpec("rec" if k == "rec" else "attn", 1,
                                  window=cfg.window if k == "attn" else 0,
                                  cache="rglru" if k == "rec" else "kv") for k in kinds)
    return _grouped(StageSpec(k, 1, cache=k) for k in kinds)
