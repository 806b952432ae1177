"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "internlm2-20b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92544,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=1, head_dim=16,
        d_ff=256, vocab=256, remat="none",
    )
