"""Architecture config system (data only, no framework).

Every architecture is a frozen ArchConfig registered in ARCHS. `reduced()`
yields the CPU-smoke variant (same family and topology, tiny widths). SHAPES
names the four input-shape cells. The dry-run's `input_specs` waits for the
port's launch tooling.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    act: str = "swiglu"            # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0    # deepseek: layer 0 is dense
    # --- hybrid / ssm ---
    block_pattern: tuple = ()      # e.g. ("rec", "rec", "attn") tiled over depth
    window: int = 0                # local attention window (0 = full)
    conv_width: int = 4            # RG-LRU temporal conv width
    rglru_dim: int = 0             # lru width (0 -> d_model)
    # --- enc-dec / vlm ---
    encoder_layers: int = 0        # whisper
    cross_attn_every: int = 0      # vlm: every k-th decoder layer cross-attends
    frontend_tokens: int = 1500    # stub frontend sequence length (audio/vlm)
    causal: bool = True
    # --- TP attention layout (Model(cfg, tp_size=M) sets it; models/attention.py) ---
    attn_layout: str = "grouped"   # grouped (shard kv heads) | flat (pad+shard q heads)
    heads_padded: int = 0          # flat layout: H padded to a tp multiple

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers // 8)) if not self.block_pattern
            else max(len(self.block_pattern), 3),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads // max(1, self.n_heads // 4))),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            window=min(self.window, 64) if self.window else 0,
            rglru_dim=128 if self.rglru_dim else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            frontend_tokens=16,
            first_dense_layers=min(self.first_dense_layers, 1),
        )


# The four input-shape cells (seq_len, global_batch, kind).
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
SUBQUADRATIC = {"recurrentgemma-9b", "xlstm-125m"}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.name not in SUBQUADRATIC:
        return False, "SKIP(full-attention arch; 500k decode needs sub-quadratic mixing)"
    return True, ""


ARCHS: dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]):
    cfg = fn()
    ARCHS[cfg.name] = fn
    return fn


def get(name: str) -> ArchConfig:
    return ARCHS[name]()


def all_names() -> list[str]:
    return sorted(ARCHS)
