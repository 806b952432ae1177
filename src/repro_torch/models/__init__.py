"""repro_torch.models — model families in torch: the decoder-only
transformer (dense, MoE, GQA, local:global), the whisper encoder-decoder and
the internvl VLM. Families register into ``api.get_family``."""
from . import api, internvl, layers, transformer, whisper  # noqa: F401
from .api import (ModelConfig, ModelFamily, ParamSpec, get_family,
                  init_from_specs, resolve_device)

__all__ = ["api", "internvl", "layers", "transformer", "whisper",
           "ModelConfig", "ModelFamily", "ParamSpec", "get_family",
           "init_from_specs", "resolve_device"]
