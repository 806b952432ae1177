"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256 [arXiv:2407.21783; unverified]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "llama3-405b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128256,
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=192, vocab=256, remat="none",
    )
