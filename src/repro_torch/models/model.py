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
    COMPUTE_DTYPE,
    ParamDef,
    Params,
    embed_lookup,
    init_params,
    layer_norm,
    logits_out,
    pad_vocab,
    rms_norm,
)


def _sinusoid(pos, d: int):
    """Whisper's sinusoidal position table at int positions (..., S):
    (..., S, d) in COMPUTE_DTYPE, sines then cosines, the frequencies
    exp(-i * (log(10000) / half)) in float32 as the JAX package builds them."""
    half = d // 2
    log_t = torch.log(torch.full((), 10000.0, dtype=torch.float32, device=pos.device))
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=pos.device)
                     * (log_t / half))
    ang = pos[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(COMPUTE_DTYPE)


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


def _write_layer(view, new, active) -> None:
    """Write a layer's new cache into its views of the stacked cache; a
    leaf that already is its view (written in place) is left alone. With
    ``active`` (B,) bool, inactive slots keep their values."""
    if isinstance(view, dict):
        for k in view:
            _write_layer(view[k], new[k], active)
        return
    if new is view:
        return
    if active is not None:
        new = torch.where(active.view(-1, *[1] * (new.ndim - 1)), new, view)
    view.copy_(new)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class Model(nn.Module):
    """The served LM of one ArchConfig (any family) on one device.
    ``device=None`` means the card and raises without CUDA; the parameters
    are allocated there uninitialised until init() or a load. ``moe_impl``
    and ``moe_capacity`` reach every MoE block (the reference's
    defaults)."""

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
        d, f32 = self.cfg.d_model, torch.float32
        audio = self.cfg.family == "audio"
        defs = {
            "embed": ParamDef((self.vocab_padded, d), ("vocab", "embed")),
            "unembed": ParamDef((self.vocab_padded, d), ("vocab", "embed")),
            "final_norm_w": ParamDef((d,), ("embed",), init="ones" if audio else "zeros",
                                     dtype=f32),
        }
        if audio:
            defs["final_norm_b"] = ParamDef((d,), ("embed",), init="zeros", dtype=f32)
        return defs

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
        None, aux_loss). With aux["in_place"] each layer's new cache is
        written into cache_stacked (only the slots of aux["active"], when
        given), which is returned: a compiled decode step's caches are its
        static buffers, and restacking them would copy every layer."""
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        in_place = aux.get("in_place", False) and cache_stacked is not None
        new = []
        for i, blk in enumerate(layers):
            cache = None if cache_stacked is None else _index(cache_stacked, i)
            x, new_cache, al = blk(x, aux, cache)
            aux_sum = aux_sum + al
            if in_place:
                _write_layer(cache, new_cache, aux.get("active"))
            else:
                new.append(new_cache)
        if cache_stacked is None or in_place:
            return x, cache_stacked, aux_sum
        return x, _stack(new), aux_sum

    # ---------------- forward paths ----------------
    def _final_norm(self, x):
        if self.cfg.family == "audio":
            return layer_norm(x, self.top.final_norm_w, self.top.final_norm_b,
                              self.cfg.norm_eps)
        return rms_norm(x, self.top.final_norm_w, self.cfg.norm_eps)

    def _positions(self, b: int, s: int):
        return torch.arange(s, dtype=torch.int32, device=self.device)[None].expand(b, s)

    def aux(self, positions, frontend=None) -> dict:
        """What every block gets beside its input: positions, the sequence
        the cross attention reads (or None) and the MoE options."""
        return {"pos": positions, "frontend": frontend, "moe_impl": self.moe_impl,
                "moe_capacity": self.moe_capacity}

    def _encode(self, frontend):
        """The audio encoder (stage 0) over frontend (B, F, D) plus the
        sinusoid table. Returns enc_out (B, F, D)."""
        b, f, _ = frontend.shape
        pos = self._positions(b, f)
        x = frontend.to(COMPUTE_DTYPE) + _sinusoid(pos, self.cfg.d_model)
        x, _, _ = self._run_stage(self.stages[0], self.stage_layers[0], x, self.aux(pos), None)
        return x

    @torch.no_grad()
    def forward(self, tokens, frontend=None, caches=None, positions=None,
                last: bool = False, in_place: bool = False, active=None):
        """tokens (B, S) int; frontend (B, Sf, D) or None: the audio
        encoder's input, or the image tokens a vlm cross-attends to. With
        caches and no frontend, the caches' enc_out / frontend stand in.
        Returns (logits float32 (B, S, Vp), new caches or None, aux loss);
        with ``last``, the logits of the last position only, (B, 1, Vp).

        in_place / active (a compiled decode step, runtime/serve.py): the
        stage caches are written in place, only the active slots' when
        ``active`` is given, and the returned caches hold the same stage
        tensors."""
        b, s = tokens.shape
        if positions is None:
            positions = self._positions(b, s)
        x = embed_lookup(self.top.embed, tokens)
        stages, stage_layers = self.stages, self.stage_layers
        stage_caches = caches["stages"] if caches is not None else [None] * len(stages)
        if self.cfg.family == "audio":
            x = x + _sinusoid(positions, self.cfg.d_model)
            if caches is not None and caches.get("enc_out") is not None and frontend is None:
                kv_src = caches["enc_out"]
            elif frontend is None:
                raise ValueError("an audio forward without caches needs a frontend "
                                 "(the encoder's input)")
            else:
                kv_src = self._encode(frontend)
                if caches is not None:
                    caches = dict(caches, enc_out=kv_src)
            # the encoder stage holds no cache slot
            stages, stage_layers, stage_caches = stages[1:], stage_layers[1:], stage_caches[1:]
        elif caches is not None and frontend is None:
            kv_src = caches.get("frontend")
        else:
            kv_src = None if frontend is None else frontend.to(COMPUTE_DTYPE)
            if caches is not None and kv_src is not None:
                caches = dict(caches, frontend=kv_src)
        aux = self.aux(positions, kv_src)
        if in_place:
            aux.update(in_place=True, active=active)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_stage_caches = []
        for spec, layers, c_st in zip(stages, stage_layers, stage_caches):
            x, new_c, al = self._run_stage(spec, layers, x, aux, c_st)
            aux_total = aux_total + al
            new_stage_caches.append(new_c)
        if last:
            x = x[:, -1:]
        x = self._final_norm(x)
        logits = logits_out(x, self.top.unembed, self.cfg.vocab_size)
        new_caches = None
        if caches is not None:
            if self.cfg.family == "audio":
                new_stage_caches = [None] + new_stage_caches
            new_caches = dict(caches, stages=new_stage_caches, pos=caches["pos"] + s)
        return logits, new_caches, aux_total

    # ---------------- public APIs ----------------
    def prefill(self, batch: dict, max_len: int):
        """Run the prompt batch["tokens"] (B, S) (and batch["frontend"] when
        given) and fill fresh caches of max_len. Returns (last-position logits
        (B, Vp), caches)."""
        caches = self.make_caches(batch["tokens"].shape[0], max_len)
        logits, caches, _ = self(batch["tokens"], batch.get("frontend"), caches=caches,
                                 last=True)
        return logits[:, -1], caches

    def decode_step(self, caches: dict, token, in_place: bool = False, active=None):
        """token: (B, 1). One step with the KV / state caches; functional
        unless ``in_place`` (forward)."""
        b = token.shape[0]
        pos = caches["pos"][:, None].expand(b, 1)
        logits, caches, _ = self(token, caches=caches, positions=pos, in_place=in_place,
                                 active=active)
        return logits[:, -1], caches

    # ---------------- caches ----------------
    def make_caches(self, batch: int, max_len: int) -> dict:
        """Zeroed caches for ``batch`` requests of up to max_len tokens: one
        entry a stage (None for the cross and encoder stages), "pos", and
        the zero "enc_out" (audio) or "frontend" (vlm) that a forward with
        caches and no frontend reads."""
        stage_caches: list = []
        for spec in self.stages:
            if spec.cache is None:
                stage_caches.append(None)
            elif spec.cache == "kv":
                stage_caches.append({"kv": attention.make_cache(
                    self.cfg, batch, max_len, spec.n_layers, spec.window, self.device)})
            elif spec.cache == "rglru":
                stage_caches.append({"rglru": recurrent.make_rglru_state(
                    self.cfg, batch, spec.n_layers, self.device)})
            else:       # mlstm | slstm
                n_m, n_s = (spec.n_layers, 0) if spec.cache == "mlstm" else (0, spec.n_layers)
                st = xlstm.make_xlstm_state(self.cfg, batch, n_m, n_s, self.device)
                stage_caches.append({spec.cache: st[spec.cache]})
        out = {"stages": stage_caches,
               "pos": torch.zeros((batch,), dtype=torch.int32, device=self.device)}
        key = {"audio": "enc_out", "vlm": "frontend"}.get(self.cfg.family)
        if key is not None:
            out[key] = torch.zeros((batch, self.cfg.frontend_tokens, self.cfg.d_model),
                                   dtype=COMPUTE_DTYPE, device=self.device)
        return out
