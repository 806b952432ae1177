"""Public kernel entry points, dispatched by where the tensors lie.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain torch version. There is no other
switch: no fallback on error, no environment variable, no flag.
"""
from __future__ import annotations

import torch

from .block_quant.block_quant import block_quant_cuda, block_quant_kv_cuda
from .block_quant.ref import block_quant_ref, pack_pairs
from .decode_attention.decode_attention import decode_attention_quant_cuda
from .decode_attention.ref import decode_attention_quant_ref, dequant_kv_ref
from .dequant_matmul.dequant_matmul import dequant_matmul_cuda
from .dequant_matmul.dequant_matmul_t import dequant_matmul_t_cuda
from .dequant_matmul.ref import dequant_matmul_ref, dequant_matmul_t_ref


def dequant_matmul(x, codes, scales, codebook, block: int = 128,
                   bits: int = 8) -> torch.Tensor:
    """x (*lead, M, K) @ dequant(codes, scales) -> (*lead, M, N) in x.dtype.

    ``bits=4``: codes are nibble-packed ((*lead, K//2, N) bytes, the
    ``core.nibble`` layout). ``lead`` is at most one dim (stacked experts)."""
    if x.device.type == "cuda":
        return dequant_matmul_cuda(x, codes, scales, codebook, block, bits)
    return dequant_matmul_ref(x, codes, scales, codebook, block, bits)


def dequant_matmul_t(x, codes, scales, codebook, block: int = 128,
                     bits: int = 8) -> torch.Tensor:
    """x (M, D) @ dequant(codes, scales).T -> (M, V) in x.dtype: the
    contraction runs along the blocked axis (the tied-embeddings unembed).
    ``bits=4``: codes are (V // 2, D) bytes nibble-packed along V."""
    if x.device.type == "cuda":
        return dequant_matmul_t_cuda(x, codes, scales, codebook, block, bits)
    return dequant_matmul_t_ref(x, codes, scales, codebook, block, bits)


def block_quant(x, codebook, block: int = 128, *, pack: bool = False,
                out=None, rows=None):
    """Quantise x (rows, cols) -> (codes uint8, scales f32 (rows, cols //
    block)): bf16 round-away absmax scales and round-to-nearest codebook
    indices, bit for bit the reference's.

    ``pack=True`` stores 4-bit codes pairwise along the row (cols // 2
    bytes). ``out=(codes, scales)`` with ``rows`` (int64, distinct) writes
    input row r into row ``rows[r]`` of those buffers (viewed as rows) and
    returns them."""
    if x.device.type == "cuda":
        return block_quant_cuda(x, codebook, block, pack=pack, out=out,
                                rows=rows)
    return _block_quant_plain(x, codebook, block, pack, out, rows)


def block_quant_kv(k, v, codebook, block: int, *, pack: bool = False,
                   out_k, out_v, rows):
    """The served KV write: quantise a layer's fresh k and v rows (each
    (rows, cols), alike) into their caches ``out_k`` and ``out_v`` (each
    (codes, scales), viewed as rows) at the shared output ``rows`` — one
    kernel launch on the card, two ``block_quant`` writes' worth of bytes.
    Returns (out_k, out_v)."""
    if k.device.type == "cuda":
        return block_quant_kv_cuda(k, v, codebook, block, pack=pack,
                                   out_k=out_k, out_v=out_v, rows=rows)
    return (_block_quant_plain(k, codebook, block, pack, out_k, rows),
            _block_quant_plain(v, codebook, block, pack, out_v, rows))


def _block_quant_plain(x, codebook, block, pack, out, rows):
    codes, scales = block_quant_ref(x, codebook, block)
    if pack:
        codes = pack_pairs(codes)
    if out is None:
        return codes, scales
    out[0].view(-1, codes.shape[1])[rows] = codes
    out[1].view(-1, scales.shape[1])[rows] = scales
    return out


def decode_attention_quant(q, k_codes, k_scales, v_codes, v_scales,
                           codebook, q_positions, window: int = 0, *,
                           ring: bool = False,
                           bits: int = 8) -> torch.Tensor:
    """Masked decode attention straight from block-scaled KV codes — the
    quantised twin of ``models.layers.chunked_decode_attention``.
    ``bits=4``: codes nibble-packed pairwise along the head dim."""
    if q.device.type == "cuda":
        return decode_attention_quant_cuda(
            q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
            window, ring=ring, bits=bits)
    return decode_attention_quant_ref(
        q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
        window=window, ring=ring, bits=bits)


def dequant_kv(codes, scales, codebook, bits: int = 8,
               dtype=torch.float32) -> torch.Tensor:
    """Dequantise block-scaled KV rows: codes (..., hdc) + scales (..., 1)
    -> (..., hd)."""
    return dequant_kv_ref(codes, scales, codebook, bits, dtype)


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
