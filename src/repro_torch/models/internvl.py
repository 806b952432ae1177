"""InternVL2-26B-shaped VLM (arXiv:2404.16821), as the reference's
``repro/models/internvl.py`` computes it: an InternViT frontend stub plus
the InternLM2-20B backbone.

The modality frontend is a stub: batches carry precomputed patch
embeddings (B, n_vis_tokens, D_VIT). The model owns the MLP projector
(InternVL2's "mlp1": RMSNorm, a GELU between two projections) and prepends
the projected visual tokens to the text (``transformer.apply``'s
``vis_embed``). The backbone is the transformer (GQA); decode is textual,
so serving is the transformer's, on packed backbone weights (the projector
stays dense: it runs only in ``apply``).
"""
from __future__ import annotations

import torch

from . import transformer
from .api import (ModelConfig, ModelFamily, ParamSpec, init_from_specs,
                  register_family, torch_dtype)
from .layers import linear, rms_norm

D_VIT = 3200  # InternViT-6B hidden size


def param_specs(cfg: ModelConfig) -> dict:
    specs = transformer.param_specs(cfg)
    pd = cfg.param_dtype
    specs["vis_norm"] = ParamSpec((D_VIT,), (None,), pd)
    specs["vis_proj1"] = ParamSpec((D_VIT, cfg.d_model), ("fsdp", None), pd)
    specs["vis_proj2"] = ParamSpec((cfg.d_model, cfg.d_model),
                                   ("fsdp", None), pd)
    return specs


def _project_vis(params, vis, cfg: ModelConfig):
    """Patch embeddings (B, n, D_VIT) -> visual tokens (B, n, d_model):
    ``jax.nn.gelu``'s default, the tanh approximation, between the two
    projections."""
    h = rms_norm(vis.to(torch_dtype(cfg.dtype)), params["vis_norm"],
                 cfg.norm_eps)
    h = linear(h, params["vis_proj1"], "bnd,de->bne")
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return linear(h, params["vis_proj2"], "bne,ef->bnf")


def apply(params, batch, cfg: ModelConfig):
    """batch: {"tokens": (B, T_text), "vis": (B, n_vis, D_VIT)} -> f32
    logits (B, n_vis + T_text, V)."""
    vis_embed = _project_vis(params, batch["vis"], cfg)
    inner = {"tokens": batch["tokens"], "vis_embed": vis_embed}
    return transformer.apply(params, inner, cfg)


def decode_state_specs(cfg: ModelConfig, batch_size: int, kv_len: int,
                       slack: int = 0, windowed: bool = True) -> dict:
    # the backbone's grouped cache (internlm2 is pure global attention: the
    # one full-length group k0/v0)
    return transformer.decode_state_specs(cfg, batch_size, kv_len, slack,
                                          windowed)


def decode_step(params, state, batch, cfg: ModelConfig):
    # after prefill the visual prefix lives in the KV cache; decode is textual
    return transformer.decode_step(params, state, batch, cfg)


def init(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Seeded random parameters on ``device`` (default the card)."""
    return init_from_specs(param_specs(cfg), seed=seed, device=device)


register_family(ModelFamily(
    name="internvl",
    param_specs=param_specs,
    init=init,
    apply=apply,
    decode_state_specs=decode_state_specs,
    decode_step=decode_step,
    prefill=apply,
    supports_ragged=True,
    cache_spec=transformer.cache_spec,
    pack_layouts=transformer.pack_layouts,
))
