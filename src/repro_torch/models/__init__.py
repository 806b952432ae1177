"""repro_torch.models — model families in torch (this slice: the dense
decoder-only transformer's decode path). Families register into
``api.get_family``."""
from . import api, layers, transformer  # noqa: F401
from .api import (ModelConfig, ModelFamily, ParamSpec, get_family,
                  init_from_specs, resolve_device)

__all__ = ["api", "layers", "transformer", "ModelConfig", "ModelFamily",
           "ParamSpec", "get_family", "init_from_specs", "resolve_device"]
