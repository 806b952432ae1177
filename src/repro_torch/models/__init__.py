"""repro_torch.models — model families in torch: the decoder-only
transformer (dense, MoE, GQA, local:global), the whisper encoder-decoder,
the internvl VLM, the attention-free rwkv6 and the zamba2 hybrid (Mamba-2
layers and a shared attention block): every family the reference's configs
name. Families register into ``api.get_family``."""
from . import (api, internvl, layers, rwkv6, transformer,  # noqa: F401
               whisper, zamba2)
from .api import (ModelConfig, ModelFamily, ParamSpec, family_leaves,
                  get_family, init_from_specs, resolve_device)

__all__ = ["api", "internvl", "layers", "rwkv6", "transformer", "whisper",
           "zamba2", "ModelConfig", "ModelFamily", "ParamSpec",
           "family_leaves", "get_family", "init_from_specs",
           "resolve_device"]
