"""internvl2-26b [vlm]: InternViT stubbed (precomputed patch embeddings,
``configs.shapes.input_specs``) + InternLM2-20B backbone: 48L d_model=6144
48H (GQA kv=8) d_ff=16384 vocab=92553 [arXiv:2404.16821; hf]."""
from repro_torch.models.api import ModelConfig

ARCH_ID = "internvl2-26b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="internvl",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92553, n_vis_tokens=256,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="internvl",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=256, n_vis_tokens=8, remat="none",
    )
