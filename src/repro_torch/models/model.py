"""Model assembly: stages -> init / forward / prefill / decode.

Each stage is an nn.ModuleList of Blocks, one per layer, run by a Python
loop where the JAX package scans stacked parameters. Caches keep the JAX
package's layout, stacked over a stage's layers. Nothing here builds a
graph: every parameter is frozen (inference only), so no remat either.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention, blocks, recurrent, xlstm
from repro_torch.models.layers import (
    ParamDef,
    Params,
    embed_lookup,
    init_params,
    logits_out,
    pad_vocab,
    rms_norm,
)


class Block(nn.Module):
    """One layer of a stage: its parameters and its kind."""

    def __init__(self, cfg, spec: blocks.StageSpec, device):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.p = Params(blocks.block_defs(cfg, spec), device)

    def forward(self, x, aux: dict, cache=None):
        return blocks.block_apply(self.cfg, self.spec, self.p.tree(), x, aux, cache)


def _index(tree, i: int):
    return {k: _index(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class Model(nn.Module):
    """The served LM of one ArchConfig (dense, moe, hybrid and ssm families)
    on one device. ``device=None`` means the card and raises without CUDA;
    the parameters are allocated there uninitialised until init() or a
    load. ``moe_impl`` and ``moe_capacity`` reach every MoE block (the
    reference's defaults)."""

    def __init__(self, cfg, device=None, moe_impl: str = "sorted",
                 moe_capacity: float = 1.25):
        super().__init__()
        self.cfg = cfg
        self.stages = blocks.stages_for(cfg)
        self.vocab_padded = pad_vocab(cfg.vocab_size)
        self.device = resolve_device(device)
        self.moe_impl = moe_impl
        self.moe_capacity = moe_capacity
        self.top = Params(self._top_defs(), self.device)
        self.stage_layers = nn.ModuleList(
            nn.ModuleList(Block(cfg, spec, self.device) for _ in range(spec.n_layers))
            for spec in self.stages)

    # ---------------- params ----------------
    def _top_defs(self) -> dict:
        d = self.cfg.d_model
        return {
            "embed": ParamDef((self.vocab_padded, d), ("vocab", "embed")),
            "unembed": ParamDef((self.vocab_padded, d), ("vocab", "embed")),
            "final_norm_w": ParamDef((d,), ("embed",), init="zeros", dtype=torch.float32),
        }

    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device),
        layer by layer, in float32, stored in its storage dtype."""
        self.top.load_(init_params(self._top_defs(), generator))
        for layers in self.stage_layers:
            for blk in layers:
                blk.p.load_(init_params(blk.p.defs, generator))
        return self

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # ---------------- stage runner ----------------
    def _run_stage(self, spec, layers, x, aux, cache_stacked):
        """Run one stage's layers in order. Returns (x, new stacked cache or
        None, aux_loss)."""
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        new = []
        for i, blk in enumerate(layers):
            cache = None if cache_stacked is None else _index(cache_stacked, i)
            x, new_cache, al = blk(x, aux, cache)
            aux_sum = aux_sum + al
            new.append(new_cache)
        return x, (None if cache_stacked is None else _stack(new)), aux_sum

    # ---------------- forward paths ----------------
    def _final_norm(self, x):
        return rms_norm(x, self.top.final_norm_w, self.cfg.norm_eps)

    def _positions(self, b: int, s: int):
        return torch.arange(s, dtype=torch.int32, device=self.device)[None].expand(b, s)

    def aux(self, positions) -> dict:
        """What every block gets beside its input: positions and the MoE
        options."""
        return {"pos": positions, "moe_impl": self.moe_impl,
                "moe_capacity": self.moe_capacity}

    @torch.no_grad()
    def forward(self, tokens, caches=None, positions=None):
        """tokens (B, S) int. Returns (logits float32 (B, S, Vp), new caches
        or None, aux loss)."""
        b, s = tokens.shape
        if positions is None:
            positions = self._positions(b, s)
        x = embed_lookup(self.top.embed, tokens)
        aux = self.aux(positions)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        stage_caches = caches["stages"] if caches is not None else [None] * len(self.stages)
        new_stage_caches = []
        for spec, layers, c_st in zip(self.stages, self.stage_layers, stage_caches):
            x, new_c, al = self._run_stage(spec, layers, x, aux, c_st)
            aux_total = aux_total + al
            new_stage_caches.append(new_c)
        x = self._final_norm(x)
        logits = logits_out(x, self.top.unembed, self.cfg.vocab_size)
        new_caches = None
        if caches is not None:
            new_caches = dict(caches, stages=new_stage_caches, pos=caches["pos"] + s)
        return logits, new_caches, aux_total

    # ---------------- public APIs ----------------
    def prefill(self, batch: dict, max_len: int):
        """Run the prompt batch["tokens"] (B, S) and fill fresh caches of
        max_len. Returns (last-position logits (B, Vp), caches)."""
        caches = self.make_caches(batch["tokens"].shape[0], max_len)
        logits, caches, _ = self(batch["tokens"], caches=caches)
        return logits[:, -1], caches

    def decode_step(self, caches: dict, token):
        """token: (B, 1). One step with the KV / state caches."""
        b = token.shape[0]
        pos = caches["pos"][:, None].expand(b, 1)
        logits, caches, _ = self(token, caches=caches, positions=pos)
        return logits[:, -1], caches

    # ---------------- caches ----------------
    def make_caches(self, batch: int, max_len: int) -> dict:
        stage_caches: list = []
        for spec in self.stages:
            if spec.cache == "kv":
                stage_caches.append({"kv": attention.make_cache(
                    self.cfg, batch, max_len, spec.n_layers, spec.window, self.device)})
            elif spec.cache == "rglru":
                stage_caches.append({"rglru": recurrent.make_rglru_state(
                    self.cfg, batch, spec.n_layers, self.device)})
            else:       # mlstm | slstm
                n_m, n_s = (spec.n_layers, 0) if spec.cache == "mlstm" else (0, spec.n_layers)
                st = xlstm.make_xlstm_state(self.cfg, batch, n_m, n_s, self.device)
                stage_caches.append({spec.cache: st[spec.cache]})
        return {"stages": stage_caches,
                "pos": torch.zeros((batch,), dtype=torch.int32, device=self.device)}
