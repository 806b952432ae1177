"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1, head_dim 256)
d_ff=6912 vocab=262144, 5:1 local(512):global attention, QK-norm, tied
embeddings [hf:google/gemma-3-1b-pt; unverified].

The reference's transformer computes this config (no sqrt(d) embedding
scale, one rope theta, SwiGLU, plain rms_norm for QK-norm), and so does the
port; it is not Hugging Face's Gemma 3 block."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "gemma3-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144,
        window=512, local_global_pattern=(5, 1), qk_norm=True,
        tie_embeddings=True, rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab=256,
        window=16, local_global_pattern=(5, 1), qk_norm=True,
        tie_embeddings=True, remat="none",
    )
