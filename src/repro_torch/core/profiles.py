"""Model profiles: per-layer FLOPs + inter-layer activation sizes.

Two sources:
  * chain CNNs the paper evaluates (NiN-9, YOLOv2-17, VGG16-24), built from
    real conv arithmetic (MACs, feature-map sizes) on CIFAR-scale inputs;
  * any LM architecture config (per-transformer-block profile), read
    duck-typed from the config's attributes.

Layer enumeration follows the paper's stated counts (NiN 9 / YOLOv2 17 /
VGG16 24): ReLUs are folded into their producing layer; VGG pools, flatten
and softmax are kept as explicit (cheap) layers to reach the paper's count.
Profiles are built on the CPU; the planner moves them to its device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import ModelProfile

ACT_BITS = 16          # activations transmitted as fp16/bf16
INPUT_BITS = 8         # raw images are 8-bit per channel
RESULT_BITS_CLS = 10 * 32   # 10-class logits


def _profile(fl, w, m_down, name) -> ModelProfile:
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32))
    return ModelProfile(fl=f32(fl), w=f32(w), m_down=f32(m_down), name=name)


def _conv_chain(layers, in_hwc, result_bits, name) -> ModelProfile:
    """layers: list of ('conv', out_c, k, stride) | ('pool', k, stride) |
    ('fc', out_dim) | ('gap',) | ('softmax',). Pools may also be folded via
    ('conv+pool', out_c, k, stride, pool_k)."""
    h, w, c = in_hwc
    fl, acts = [], []
    for spec in layers:
        kind = spec[0]
        if kind in ("conv", "conv+pool"):
            out_c, k, stride = spec[1], spec[2], spec[3]
            h = max(1, (h + stride - 1) // stride)
            w = max(1, (w + stride - 1) // stride)
            flops = 2.0 * k * k * c * out_c * h * w
            c = out_c
            if kind == "conv+pool":
                pk = spec[4]
                flops += float(h * w * c * pk * pk)
                h, w = max(1, h // pk), max(1, w // pk)
        elif kind == "pool":
            k, stride = spec[1], spec[2]
            flops = float(h * w * c * k * k)
            h, w = max(1, h // stride), max(1, w // stride)
        elif kind == "gap":
            flops = float(h * w * c)
            h, w = 1, 1
        elif kind == "fc":
            out_dim = spec[1]
            flops = 2.0 * (h * w * c) * out_dim
            h, w, c = 1, 1, out_dim
        elif kind == "norm":
            flops = 2.0 * h * w * c
        elif kind == "flatten":
            flops = 0.0
        elif kind == "softmax":
            flops = 5.0 * c
        else:
            raise ValueError(kind)
        fl.append(flops)
        acts.append(h * w * c * ACT_BITS)
    f = len(fl)
    w_bits = np.empty(f + 1)
    w_bits[0] = in_hwc[0] * in_hwc[1] * in_hwc[2] * INPUT_BITS
    w_bits[1:] = acts
    w_bits[f] = 0.0                       # split at F: nothing uploaded
    m_down = np.full(f + 1, float(result_bits))
    m_down[f] = 0.0                       # split at F: nothing comes back
    return _profile(fl, w_bits, m_down, name)


def nin() -> ModelProfile:
    """Network-in-Network, 9 conv/mlpconv layers (pools folded), CIFAR-10."""
    layers = [
        ("conv", 192, 5, 1), ("conv", 160, 1, 1), ("conv+pool", 96, 1, 1, 2),
        ("conv", 192, 5, 1), ("conv", 192, 1, 1), ("conv+pool", 192, 1, 1, 2),
        ("conv", 192, 3, 1), ("conv", 192, 1, 1), ("conv", 10, 1, 1),
    ]
    return _conv_chain(layers, (32, 32, 3), RESULT_BITS_CLS, "nin")


def yolov2() -> ModelProfile:
    """YOLOv2-style chain, 17 conv layers (pools folded), 64x64 input."""
    layers = [
        ("conv+pool", 32, 3, 1, 2),
        ("conv+pool", 64, 3, 1, 2),
        ("conv", 128, 3, 1), ("conv", 64, 1, 1), ("conv+pool", 128, 3, 1, 2),
        ("conv", 256, 3, 1), ("conv", 128, 1, 1), ("conv+pool", 256, 3, 1, 2),
        ("conv", 512, 3, 1), ("conv", 256, 1, 1), ("conv", 512, 3, 1),
        ("conv", 256, 1, 1), ("conv+pool", 512, 3, 1, 2),
        ("conv", 1024, 3, 1), ("conv", 512, 1, 1), ("conv", 1024, 3, 1),
        ("conv", 125, 1, 1),
    ]
    # detection output: SxSx125 fp16
    return _conv_chain(layers, (64, 64, 3), 2 * 2 * 125 * ACT_BITS, "yolov2")


def vgg16() -> ModelProfile:
    """VGG16, enumerated to the paper's 24 layers (input-norm + 13 conv +
    5 pool + flatten + 3 fc + softmax)."""
    layers = [
        ("norm",),
        ("conv", 64, 3, 1), ("conv", 64, 3, 1), ("pool", 2, 2),
        ("conv", 128, 3, 1), ("conv", 128, 3, 1), ("pool", 2, 2),
        ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("conv", 256, 3, 1), ("pool", 2, 2),
        ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool", 2, 2),
        ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("conv", 512, 3, 1), ("pool", 2, 2),
        ("flatten",),
        ("fc", 512), ("fc", 512), ("fc", 10),
        ("softmax",),
    ]
    return _conv_chain(layers, (32, 32, 3), RESULT_BITS_CLS, "vgg16")


# --------------------------------------------------------------------------
# LM architecture profiles (per-transformer-block)
# --------------------------------------------------------------------------
def lm_block_flops(cfg, seq: int) -> tuple[float, float]:
    """(dense_block_flops, moe_block_flops_active) for one token batch of
    length `seq` through one block. GQA-aware; counts fwd only (inference)."""
    d = cfg.d_model
    hd = d // cfg.n_heads
    kv_dim = cfg.n_kv_heads * hd
    attn_proj = 2.0 * seq * d * (d + 2 * kv_dim + d)          # q,k,v,o matmuls
    attn_core = 4.0 * seq * seq * d                            # scores + AV
    if getattr(cfg, "window", None):
        w = min(cfg.window, seq)
        attn_core = 4.0 * seq * w * d
    if cfg.d_ff > 0:
        mlp = 6.0 * seq * d * cfg.d_ff                         # SwiGLU: 3 matmuls
    else:
        mlp = 0.0
    moe_mlp = mlp
    if getattr(cfg, "n_experts", 0):
        active = cfg.top_k + getattr(cfg, "n_shared_experts", 0)
        moe_mlp = active * 6.0 * seq * d * cfg.moe_d_ff
    return attn_proj + attn_core + mlp, attn_proj + attn_core + moe_mlp


def from_arch_config(cfg, seq: int, batch: int = 1) -> ModelProfile:
    """Per-block profile of an LM arch: fl[i] = FLOPs of block i, w[s] =
    bits of the residual-stream activation crossing the split."""
    dense_f, moe_f = lm_block_flops(cfg, seq)
    n = cfg.n_layers
    fl = np.empty(n)
    for i in range(n):
        is_moe = bool(getattr(cfg, "n_experts", 0)) and (
            i % max(1, getattr(cfg, "moe_every", 1)) == 0
        )
        fl[i] = (moe_f if is_moe else dense_f) * batch
    act_bits = batch * seq * cfg.d_model * ACT_BITS
    w = np.full(n + 1, float(act_bits))
    w[0] = batch * seq * 32.0  # raw token ids
    w[n] = 0.0
    m_down = np.full(n + 1, float(batch * cfg.vocab_size * ACT_BITS))
    m_down[n] = 0.0
    return _profile(fl, w, m_down, getattr(cfg, "name", "lm"))
