"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, d_expert=1408, vocab=151936,
        n_experts=60, experts_per_token=4, n_shared_experts=4,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=48, d_expert=48, vocab=256,
        n_experts=8, experts_per_token=4, n_shared_experts=2,
        remat="none",
    )
