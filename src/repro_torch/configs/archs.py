"""The 10 assigned architectures, as data (the same configs as the JAX package).

[source; verified-tier] tags are recorded next to each config.
"""
from repro_torch.configs.base import ArchConfig, register


@register
def llama32_vision_11b() -> ArchConfig:
    # [hf:meta-llama/Llama-3.2-11B-Vision; unverified] — cross-attn image layers
    return ArchConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, rope_theta=5e5,
        cross_attn_every=5, frontend_tokens=1601,
    )


@register
def qwen2_1_5b() -> ArchConfig:
    # [arXiv:2407.10671; hf] — GQA, QKV bias
    return ArchConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    )


@register
def qwen15_0_5b() -> ArchConfig:
    # [hf:Qwen/Qwen1.5-0.5B; hf] — QKV bias
    return ArchConfig(
        name="qwen1.5-0.5b", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab_size=151936, qkv_bias=True, rope_theta=1e6,
    )


@register
def phi3_medium_14b() -> ArchConfig:
    # [arXiv:2404.14219; unverified] — RoPE SwiGLU GQA
    return ArchConfig(
        name="phi3-medium-14b", family="dense",
        n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab_size=100352,
    )


@register
def internlm2_20b() -> ArchConfig:
    # [arXiv:2403.17297; hf] — GQA
    return ArchConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92544, rope_theta=1e6,
    )


@register
def llama4_scout_17b_a16e() -> ArchConfig:
    # [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE 16e top-1
    return ArchConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab_size=202048, rope_theta=5e5,
        n_experts=16, top_k=1, moe_d_ff=8192, n_shared_experts=1,
    )


@register
def deepseek_moe_16b() -> ArchConfig:
    # [arXiv:2401.06066; hf] — 2 shared + 64 routed top-6, fine-grained
    return ArchConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
        first_dense_layers=1,
    )


@register
def recurrentgemma_9b() -> ArchConfig:
    # [arXiv:2402.19427; unverified] — RG-LRU + local attn, 1 attn : 2 rec
    return ArchConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab_size=256000, head_dim=256,
        block_pattern=("rec", "rec", "attn"), window=2048,
        rglru_dim=4096, conv_width=4, act="gelu",
    )


@register
def xlstm_125m() -> ArchConfig:
    # [arXiv:2405.04517; unverified] — alternating sLSTM + mLSTM blocks
    return ArchConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, head_dim=192,
        block_pattern=("mlstm", "slstm"),
    )


@register
def whisper_small() -> ArchConfig:
    # [arXiv:2212.04356; unverified] — enc-dec, conv frontend (stub)
    return ArchConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=51865, act="gelu",
        encoder_layers=12, frontend_tokens=1500, rope_theta=0.0,
    )
