"""repro_torch.configs — the architectures the port serves (``--arch <id>``)
and the input-shape cells (``shapes``).

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests); paper-100m also ``small()``.
``ASSIGNED`` lists every config but paper-100m, as the reference's does.
llama3-405b runs on the transformer family; at full size its packed
weights (about 215 GB at 4.25 bits) exceed one card, so it is exercised
at smoke size on the CPU."""
from __future__ import annotations

from . import (deepseek_7b, gemma3_1b, internlm2_20b, internvl2_26b,
               llama3_405b, llama4_scout_17b_a16e, paper_100m,
               qwen2_moe_a2_7b, rwkv6_1_6b, shapes, whisper_large_v3,
               zamba2_2_7b)
from .shapes import SHAPES, Shape, applicable, input_specs, smoke_shape

_MODULES = [
    llama4_scout_17b_a16e, qwen2_moe_a2_7b, llama3_405b, internlm2_20b,
    gemma3_1b, deepseek_7b, rwkv6_1_6b, whisper_large_v3, internvl2_26b,
    zamba2_2_7b, paper_100m,
]

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ASSIGNED = [m.ARCH_ID for m in _MODULES if m is not paper_100m]


def get_config(arch_id: str, variant: str = "full"):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (known: {sorted(ARCHS)})")
    return getattr(ARCHS[arch_id], variant)()


__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "Shape", "applicable",
           "get_config", "input_specs", "shapes", "smoke_shape"]
