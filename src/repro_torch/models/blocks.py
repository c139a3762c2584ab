"""Residual blocks: one param-def + apply pair per block kind.

Kinds ported:
  attn    pre-norm GQA self-attention + MLP (optionally MoE, optionally
          local-window)
  rec     RG-LRU temporal-mixing block + MLP (recurrentgemma)
  mlstm / slstm   xLSTM blocks
and stage lists for the dense, moe, hybrid and ssm families. The cross /
enc / dec kinds and the audio and vlm families wait for their slice of the
port (ROADMAP queue 1, item 4) and raise NotImplementedError.

block_apply(cfg, spec, p, x, aux, cache) -> (x, new_cache, aux_loss)
`aux` carries {"pos": (B, S)} and, for MoE blocks, "moe_impl" and
"moe_capacity" (defaults "sorted" and 1.25, the reference's).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention, moe, recurrent, xlstm
from repro_torch.models.layers import ParamDef, mlp_apply, mlp_defs, rms_norm

_LATER = "ROADMAP.md queue 1, item 4: {} is not ported yet"


@dataclasses.dataclass(frozen=True)
class StageSpec:
    kind: str
    n_layers: int
    moe: bool = False
    window: int = 0
    causal: bool = True
    cache: str | None = "kv"     # kv | rglru | mlstm | slstm | None


def _norm_defs(cfg, name):
    return {f"{name}_w": ParamDef((cfg.d_model,), ("embed",), init="zeros",
                                  dtype=torch.float32)}


def _norm(cfg, p, name, x):
    return rms_norm(x, p[f"{name}_w"], cfg.norm_eps)


def _check_kind(cfg, spec: StageSpec) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(_LATER.format("the audio family (LayerNorm blocks)"))
    if spec.kind not in ("attn", "rec", "mlstm", "slstm"):
        raise NotImplementedError(_LATER.format(f"block kind {spec.kind!r}"))


def block_defs(cfg, spec: StageSpec) -> dict:
    _check_kind(cfg, spec)
    d: dict = _norm_defs(cfg, "ln1")
    if spec.kind in ("mlstm", "slstm"):
        d[spec.kind] = (xlstm.mlstm_defs if spec.kind == "mlstm" else xlstm.slstm_defs)(cfg)
        return d
    if spec.kind == "attn":
        d["attn"] = attention.attn_defs(cfg)
    else:
        d["rglru"] = recurrent.rglru_defs(cfg)
    d.update(_norm_defs(cfg, "ln2"))
    if spec.moe:
        d["moe"] = moe.moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.act)
    return d


def block_apply(cfg, spec: StageSpec, p: dict, x, aux: dict, cache=None):
    """Returns (x, new_cache, aux_loss); aux_loss is 0 but for MoE blocks."""
    _check_kind(cfg, spec)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind in ("mlstm", "slstm"):
        apply = xlstm.mlstm_apply if spec.kind == "mlstm" else xlstm.slstm_apply
        h, st = apply(p[spec.kind], _norm(cfg, p, "ln1", x), cfg,
                      state=None if cache is None else cache.get(spec.kind))
        return x + h, (None if st is None else {spec.kind: st}), zero
    if spec.kind == "attn":
        h, kv_cache = attention.attn_apply(
            p["attn"], _norm(cfg, p, "ln1", x), cfg, aux["pos"],
            cache=None if cache is None else cache.get("kv"),
            causal=spec.causal, window=spec.window)
        new_cache = None if kv_cache is None else {"kv": kv_cache}
    else:
        h, st = recurrent.rglru_apply(
            p["rglru"], _norm(cfg, p, "ln1", x), cfg,
            state=None if cache is None else cache.get("rglru"))
        new_cache = None if st is None else {"rglru": st}
    x = x + h
    if spec.moe:
        y, aux_l = moe.moe_apply(p["moe"], _norm(cfg, p, "ln2", x), cfg,
                                 impl=aux.get("moe_impl", "sorted"),
                                 capacity_factor=aux.get("moe_capacity", 1.25))
        return x + y, new_cache, aux_l
    return x + mlp_apply(p["mlp"], _norm(cfg, p, "ln2", x), cfg.act), new_cache, zero


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
    the architecture's topology: dense, moe, hybrid and ssm families."""
    fam = cfg.family
    if fam == "dense":
        return [StageSpec("attn", cfg.n_layers)]
    if fam == "moe":
        stages = []
        if cfg.first_dense_layers:
            stages.append(StageSpec("attn", cfg.first_dense_layers, moe=False))
        stages.append(StageSpec("attn", cfg.n_layers - cfg.first_dense_layers, moe=True))
        return stages
    if fam not in ("hybrid", "ssm"):
        raise NotImplementedError(_LATER.format(f"the {fam!r} family"))
    # tile block_pattern (e.g. rec,rec,attn) over depth, grouping runs
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)] for i in range(cfg.n_layers)]
    if fam == "hybrid":
        return _grouped(StageSpec("rec" if k == "rec" else "attn", 1,
                                  window=cfg.window if k == "attn" else 0,
                                  cache="rglru" if k == "rec" else "kv") for k in kinds)
    return _grouped(StageSpec(k, 1, cache=k) for k in kinds)
