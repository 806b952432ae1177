"""Plain torch version of the block-absmax quantisation.

x (rows, cols), blocks along the last dim (one scale per (row, block)):
scale = absmax of the block rounded to bf16 away from zero (never below the
absmax, so |x| / scale <= 1); code = number of codebook midpoints strictly
below x / scale (a zero scale divides by 1.0). The function of the reference
oracle ``repro/kernels/block_quant/ref.py:block_quant_ref``, bit for bit.

``pack_pairs`` is the quantised KV cache's 4-bit layout: byte j of a row
holds code 2j in its low nibble and code 2j + 1 in its high nibble.

This is what ``kernels.ops.block_quant`` runs for CPU tensors, and what the
CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def round_away_bf16(s: torch.Tensor) -> torch.Tensor:
    """f32 ``s`` >= 0 rounded to bf16, one bf16 ulp up where the
    round-to-nearest cast fell below ``s``; returned as f32."""
    s16 = s.to(torch.bfloat16)
    up = (s16.view(torch.int16) + 1).view(torch.bfloat16)
    return torch.where(s16.float() < s, up.float(), s16.float())


def midpoints(codebook: torch.Tensor) -> torch.Tensor:
    """Decision points of a sorted codebook, formed in f32 as the
    reference forms them: ``(cb[1:] + cb[:-1]) * 0.5``."""
    cb = codebook.float()
    return (cb[1:] + cb[:-1]) * 0.5


def block_quant_ref(x, codebook, block: int = 128):
    """Returns (codes uint8 (rows, cols), scales f32 (rows, cols // block))."""
    rows, cols = x.shape
    xb = x.float().reshape(rows, cols // block, block)
    scales = round_away_bf16(xb.abs().amax(dim=-1))
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    norm = (xb / safe[..., None]).reshape(rows, cols)
    codes = torch.searchsorted(midpoints(codebook), norm)
    return codes.to(torch.uint8), scales


def pack_pairs(codes: torch.Tensor) -> torch.Tensor:
    """(..., n) 4-bit codes -> (..., n // 2) bytes, pairs along the last dim."""
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def block_dequant_ref(codes, scales, codebook, block: int = 128,
                      dtype=torch.bfloat16):
    rows, cols = codes.shape
    vals = codebook.float()[codes.long()].reshape(rows, cols // block, block)
    return (vals * scales.float()[..., None]).reshape(rows, cols).to(dtype)
