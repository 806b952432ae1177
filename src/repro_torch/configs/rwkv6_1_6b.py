"""rwkv6-1.6b "Finch" [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — data-dependent decay [arXiv:2404.05892; unverified]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "rwkv6-1.6b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="rwkv6",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab=65536,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="rwkv6",
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab=256, remat="none",
    )
