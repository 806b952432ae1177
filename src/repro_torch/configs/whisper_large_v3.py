"""whisper-large-v3 [audio]: 32L(enc)+32L(dec) d_model=1280 20H (MHA)
d_ff=5120 vocab=51866, enc-dec; conv/mel frontend stubbed (requests carry
precomputed 1500-frame embeddings) [arXiv:2212.04356; unverified]. Both
stacks are modelled: 32 encoder and 32 decoder layers."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "whisper-large-v3"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="whisper",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20,
        n_kv_heads=20, head_dim=64, d_ff=5120, vocab=51866,
        enc_seq=1500, tie_embeddings=True, rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="whisper",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, enc_seq=32,
        tie_embeddings=True, remat="none",
    )
