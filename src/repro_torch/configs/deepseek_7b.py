"""deepseek-7b [dense]: 30L d_model=4096 32H (MHA, kv=32) d_ff=11008
vocab=102400 — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "deepseek-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab=102400,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=160, vocab=256, remat="none",
    )
