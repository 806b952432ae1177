"""repro_torch.configs — the architectures the port serves (``--arch <id>``)
and the input-shape cells (``shapes``).

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests); paper-100m also ``small()``.
The reference's other three configs (llama3-405b, rwkv6, zamba2) come with
their model families."""
from __future__ import annotations

from . import (deepseek_7b, gemma3_1b, internlm2_20b, internvl2_26b,
               llama4_scout_17b_a16e, paper_100m, qwen2_moe_a2_7b, shapes,
               whisper_large_v3)
from .shapes import SHAPES, Shape, applicable, input_specs, smoke_shape

_MODULES = [llama4_scout_17b_a16e, qwen2_moe_a2_7b, internlm2_20b,
            gemma3_1b, deepseek_7b, whisper_large_v3, internvl2_26b,
            paper_100m]

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def get_config(arch_id: str, variant: str = "full"):
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ported: "
                       f"{sorted(ARCHS)})")
    return getattr(ARCHS[arch_id], variant)()


__all__ = ["ARCHS", "SHAPES", "Shape", "applicable", "get_config",
           "input_specs", "shapes", "smoke_shape"]
