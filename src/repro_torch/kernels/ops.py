"""Public kernel entry points, dispatched by where the tensors lie.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain torch version. There is no other
switch: no fallback on error, no environment variable, no flag.
"""
from __future__ import annotations

import torch

from .dequant_matmul.dequant_matmul import dequant_matmul_cuda
from .dequant_matmul.ref import dequant_matmul_ref


def dequant_matmul(x, codes, scales, codebook, block: int = 128,
                   bits: int = 8) -> torch.Tensor:
    """x (*lead, M, K) @ dequant(codes, scales) -> (*lead, M, N) in x.dtype.

    ``bits=4``: codes are nibble-packed ((*lead, K//2, N) bytes, the
    ``core.nibble`` layout). ``lead`` is at most one dim (stacked experts)."""
    if x.device.type == "cuda":
        return dequant_matmul_cuda(x, codes, scales, codebook, block, bits)
    return dequant_matmul_ref(x, codes, scales, codebook, block, bits)


def dequant_rows(codes, scales, codebook, block: int = 128, dtype=None,
                 nibble=None) -> torch.Tensor:
    """Dequantise gathered rows of a packed weight (the embedding lookup):
    codes (..., N) uint8, scales (..., N // block) -> (..., N).

    ``nibble`` ((...,) ints in {0, 1}): the gathered code rows are nibble
    bytes; each row takes its low (0) or high (1) nibble. ``dtype=None``
    returns float32."""
    c = codes.long()
    if nibble is not None:
        c = (c >> (nibble.long() * 4)[..., None]) & 0xF
    n = c.shape[-1]
    vals = codebook.float()[c].reshape(*c.shape[:-1], n // block, block)
    out = vals * scales.float()[..., None]
    return out.reshape(c.shape).to(dtype or torch.float32)
