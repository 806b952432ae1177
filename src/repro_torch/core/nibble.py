"""Nibble (4-bit) code packing: two codes per uint8 byte along the K dim.

The layout is the reference's per-K-tile half interleave: K rows are grouped
into tiles of ``nibble_k_tile(K)`` rows; within each tile the first half of
the rows occupies the low nibbles and the second half the high nibbles of a
``(tile/2, N)`` byte block::

    lo = bytes & 0xF   -> tile rows [0, tile/2)
    hi = bytes >> 4    -> tile rows [tile/2, tile)

The CUDA ``dequant_matmul`` kernel takes ``tile`` as an argument and decodes
both nibbles of one byte load into rows ``t*tile + r`` and
``t*tile + tile/2 + r``. Plain torch, device-agnostic.
"""
from __future__ import annotations

import torch

# The reference kernel's K tile; kept so the packed bytes are identical.
NIBBLE_K_TILE = 256


def nibble_k_tile(K: int) -> int:
    """Interleave tile for a contraction dim of ``K`` rows (``K`` even):
    ``min(256, K)`` when it divides K, else one global half-split tile."""
    if K % 2:
        raise ValueError(f"nibble packing needs an even K, got {K}")
    t = min(NIBBLE_K_TILE, K)
    return t if (K % t == 0 and t % 2 == 0) else K


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """codes (*lead, K, N) uint8 with values < 16 -> (*lead, K//2, N) bytes."""
    *lead, K, N = codes.shape
    t = nibble_k_tile(K)
    c = codes.reshape(*lead, K // t, 2, t // 2, N)
    lo, hi = c[..., 0, :, :], c[..., 1, :, :]
    return (lo | (hi << 4)).reshape(*lead, K // 2, N)


def unpack_nibbles(packed: torch.Tensor, K: int) -> torch.Tensor:
    """packed (*lead, K//2, N) bytes -> (*lead, K, N) uint8 codes < 16."""
    *lead, Kp, N = packed.shape
    if Kp * 2 != K:
        raise ValueError(f"packed rows {Kp} do not hold K={K} codes")
    t = nibble_k_tile(K)
    p = packed.reshape(*lead, K // t, t // 2, N)
    c = torch.stack([p & 0xF, p >> 4], dim=-3)   # (*lead, K//t, 2, t//2, N)
    return c.reshape(*lead, K, N)


def nibble_row_coords(rows, K: int):
    """Map logical row ids -> (packed byte row, nibble index in {0, 1}).

    For gathers along the packed dim (embedding lookups). Accepts integer
    tensors (or numpy arrays) of any shape."""
    t = nibble_k_tile(K)
    half = t // 2
    tile, i = rows // t, rows % t
    return tile * half + i % half, i // half
