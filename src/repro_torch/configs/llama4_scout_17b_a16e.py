"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed experts top-1 + 1 shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Modelled with standard RoPE GQA (not iRoPE chunked attention) — therefore
treated as full-attention for the long_500k skip rule (DESIGN.md)."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, d_expert=8192, vocab=202048,
        n_experts=16, experts_per_token=1, n_shared_experts=1,
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, d_expert=128, vocab=256,
        n_experts=4, experts_per_token=1, n_shared_experts=1,
        remat="none",
    )
