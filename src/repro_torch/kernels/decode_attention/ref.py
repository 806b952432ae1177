"""Plain torch version of decode attention over a quantised KV cache.

Compositional, as the reference oracle
``repro/kernels/decode_attention/ref.py`` is: dequantise the block-scaled K/V
rows (codebook gather x per-(token, head) scale, nibble unpack along hd for
4-bit codes), then run the port's dense masked
``models.layers.chunked_decode_attention`` (imported lazily: the kernels
package does not depend on models at import time). Its ring, window and
causal masks are therefore those of the dense path by construction.

Layout (one cache group, one layer): q (B, T, H, hd); codes (B, S, K, hdc)
uint8, hdc = hd (8-bit) or hd // 2 (4-bit: byte j holds element 2j in its
low nibble and 2j + 1 in its high nibble); scales (B, S, K, 1) f32;
q_positions (B, T) int32.

This is what ``kernels.ops.decode_attention_quant`` runs for CPU tensors, and
what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def unpack_nibbles_hd(codes: torch.Tensor) -> torch.Tensor:
    """(..., hd // 2) nibble-packed bytes -> (..., hd) 4-bit codes."""
    pair = torch.stack([codes & 0xF, codes >> 4], dim=-1)
    return pair.reshape(*codes.shape[:-1], 2 * codes.shape[-1])


def dequant_kv_ref(codes, scales, codebook, bits: int,
                   dtype=torch.float32) -> torch.Tensor:
    """codes (..., hdc) uint8 + scales (..., 1) f32 -> values (..., hd)."""
    if bits == 4:
        codes = unpack_nibbles_hd(codes)
    vals = codebook.float()[codes.long()] * scales.float()
    return vals.to(dtype)


def decode_attention_quant_ref(q, k_codes, k_scales, v_codes, v_scales,
                               codebook, q_positions, *, window=0,
                               ring: bool = False, bits: int = 8,
                               dequant_dtype=torch.float32) -> torch.Tensor:
    """Dequantise the whole cache, then the dense path's masked chunked
    decode attention. Returns (B, T, H, hd) in ``q.dtype``."""
    from repro_torch.models.layers import chunked_decode_attention
    k = dequant_kv_ref(k_codes, k_scales, codebook, bits, dequant_dtype)
    v = dequant_kv_ref(v_codes, v_scales, codebook, bits, dequant_dtype)
    return chunked_decode_attention(q, k, v, q_positions, window=window,
                                    ring=ring)
