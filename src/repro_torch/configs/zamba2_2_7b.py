"""zamba2-2.7b [hybrid]: 54L Mamba2 d_model=2560 (d_inner 5120, ssm_state 64)
+ shared full-attention block (32H) applied every 6 layers, d_ff=10240,
vocab=32000 [arXiv:2411.15242; hf]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "zamba2-2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="zamba2",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000,
        ssm_state=64, d_inner=5120, attn_every=6,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="zamba2",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=256,
        ssm_state=16, d_inner=256, attn_every=2, remat="none",
    )
