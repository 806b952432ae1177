"""paper-100m: the paper's own experimental vehicle, a llama-style dense
LM. ``full()`` is the ~100M-parameter config; ``small()`` the CPU-sized
variant of the reference's example and benchmarks; ``smoke()`` for tests."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "paper-100m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="transformer",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32768, rope_theta=10000.0,
    )


def small() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-small", family="transformer",
        n_layers=6, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=704, vocab=2048, rope_theta=10000.0, remat="none",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="transformer",
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=128, vocab=256, remat="none",
    )
