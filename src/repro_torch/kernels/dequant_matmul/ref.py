"""Plain torch versions of the fused dequantise-matmuls.

y = x @ dequant(codes, scales): x (*lead, M, K); codes (*lead, K, N) uint8,
or (*lead, K // 2, N) nibble-packed bytes with ``bits=4`` (the
``core.nibble`` layout); scales (*lead, K, N // block), blocks along the
output dim. The weight is dequantised in f32, the product taken in f32 and
the result cast to ``x.dtype`` -- the function of the reference oracle
``repro/kernels/dequant_matmul/ref.py:dequant_matmul_ref``. The reference's
M=1 pad and N-panels worked around XLA on the CPU and are not carried over.

``dequant_matmul_t_ref`` is the transposed variant (the tied-embeddings
unembed): y = x (M, D) @ dequant(codes, scales).T for codes (V, D), or
(V // 2, D) bytes nibble-packed along V, with scales (V, D // block) blocked
along the contraction -- the reference oracle ``dequant_matmul_t_ref``.

These are what ``kernels.ops`` runs for CPU tensors, and what the CUDA
kernels are held against on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.nibble import unpack_nibbles


def dequant_weight(codes, scales, codebook, block: int = 128,
                   bits: int = 8) -> torch.Tensor:
    """Dense f32 weight (*lead, K, N) of a packed (codes, scales) pair."""
    if bits == 4:
        codes = unpack_nibbles(codes, 2 * codes.shape[-2])
    *lead, K, N = codes.shape
    vals = codebook.float()[codes.long()].reshape(*lead, K, N // block, block)
    return (vals * scales.float()[..., None]).reshape(*lead, K, N)


def dequant_matmul_ref(x, codes, scales, codebook, block: int = 128,
                       bits: int = 8) -> torch.Tensor:
    deq = dequant_weight(codes, scales, codebook, block, bits)
    return torch.matmul(x.float(), deq).to(x.dtype)


def dequant_matmul_t_ref(x, codes, scales, codebook, block: int = 128,
                         bits: int = 8) -> torch.Tensor:
    """x (M, D) @ dequant(codes, scales).T -> (M, V) in x.dtype, the
    product taken in f32. The (V, D) table has the layout of a normal
    weight with V in the place of K, so it dequantises the same way."""
    table = dequant_weight(codes, scales, codebook, block, bits)
    return torch.matmul(x.float(), table.t()).to(x.dtype)
