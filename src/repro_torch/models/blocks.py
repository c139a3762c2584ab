"""Residual blocks: one param-def + apply pair per block kind.

Kinds ported:
  attn    pre-norm GQA self-attention + MLP (optionally local-window)
  rec     RG-LRU temporal-mixing block + MLP (recurrentgemma)
and stage lists for the dense and hybrid families. MoE, cross / enc / dec
and the xLSTM kinds wait for their slices of the port (ROADMAP queue 1,
item 4) and raise NotImplementedError.

block_apply(cfg, spec, p, x, aux, cache) -> (x, new_cache, aux_loss)
`aux` carries {"pos": (B, S)}.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention, recurrent
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
    if spec.kind not in ("attn", "rec"):
        raise NotImplementedError(_LATER.format(f"block kind {spec.kind!r}"))
    if spec.moe:
        raise NotImplementedError(_LATER.format("MoE"))


def block_defs(cfg, spec: StageSpec) -> dict:
    _check_kind(cfg, spec)
    d: dict = _norm_defs(cfg, "ln1")
    if spec.kind == "attn":
        d["attn"] = attention.attn_defs(cfg)
    else:
        d["rglru"] = recurrent.rglru_defs(cfg)
    d.update(_norm_defs(cfg, "ln2"))
    d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.act)
    return d


def block_apply(cfg, spec: StageSpec, p: dict, x, aux: dict, cache=None):
    """Returns (x, new_cache, aux_loss); aux_loss is 0 (no MoE)."""
    _check_kind(cfg, spec)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
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
    x = x + mlp_apply(p["mlp"], _norm(cfg, p, "ln2", x), cfg.act)
    return x, new_cache, zero


def stages_for(cfg) -> list[StageSpec]:
    """The stage list (consecutive same-kind blocks grouped) that realizes
    the architecture's topology: dense and hybrid families."""
    fam = cfg.family
    if fam == "dense":
        return [StageSpec("attn", cfg.n_layers)]
    if fam == "hybrid":
        # tile block_pattern (e.g. rec,rec,attn) over depth, grouping runs
        pattern = cfg.block_pattern
        stages: list[StageSpec] = []
        for i in range(cfg.n_layers):
            k = pattern[i % len(pattern)]
            spec = StageSpec(
                "rec" if k == "rec" else "attn", 1,
                window=cfg.window if k == "attn" else 0,
                cache="rglru" if k == "rec" else "kv")
            if stages and stages[-1].kind == spec.kind:
                stages[-1] = dataclasses.replace(stages[-1], n_layers=stages[-1].n_layers + 1)
            else:
                stages.append(spec)
        return stages
    raise NotImplementedError(_LATER.format(f"the {fam!r} family"))
