"""repro_torch.configs — the architectures the port serves (``--arch <id>``).

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests); paper-100m also ``small()``.
The reference's other five configs (llama3-405b, rwkv6, zamba2, whisper,
internvl) come with their model families."""
from __future__ import annotations

from . import (deepseek_7b, gemma3_1b, internlm2_20b, llama4_scout_17b_a16e,
               paper_100m, qwen2_moe_a2_7b)

_MODULES = [llama4_scout_17b_a16e, qwen2_moe_a2_7b, internlm2_20b,
            gemma3_1b, deepseek_7b, paper_100m]

ARCHS = {m.ARCH_ID: m for m in _MODULES}


def get_config(arch_id: str, variant: str = "full"):
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ported: "
                       f"{sorted(ARCHS)})")
    return getattr(ARCHS[arch_id], variant)()


__all__ = ["ARCHS", "get_config"]
