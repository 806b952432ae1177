"""Wrapper of the CUDA ``dequant_matmul`` kernel (``kernels/csrc``).

``dequant_matmul_cuda(x, codes, scales, codebook, block, bits)`` computes
``x (*lead, M, K) @ dequant(codes, scales) -> (*lead, M, N)`` on the card:
checks every operand, allocates the output (and, for K-split launches, the
f32 partial sums) with ``torch.empty``, launches on the current stream and
raises on a non-zero ``cudaError_t``. It never falls back to the plain
version. ``launches`` counts the launches it made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.nibble import nibble_k_tile
from repro_torch.kernels import build

# Launches made by dequant_matmul_cuda since the count was last set to 0.
launches = 0

TILE_N = 128      # output columns per block (csrc kTileN)
CHUNK = 128       # code rows per staged chunk (csrc kChunk)
BLOCKS = (32, 64, 128)


def m_tile(M: int) -> int:
    """Rows per block: the power of two >= M, at most 16 (csrc)."""
    mt = 1
    while mt < M and mt < 16:
        mt *= 2
    return mt


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _n_chunks(K: int, bits: int, tile: int) -> int:
    half = tile // 2 if bits == 4 else K
    n_tiles = K // tile if bits == 4 else 1
    return n_tiles * -(-half // CHUNK)


def choose_splits(E: int, M: int, K: int, N: int, bits: int, tile: int,
                  m_tile: int, n_sm: int) -> int:
    """K splits across blocks: enough blocks for two per SM, never more
    splits than chunks of code rows."""
    base = -(-N // TILE_N) * -(-M // m_tile) * E
    want = -(-2 * n_sm // base)
    return max(1, min(_n_chunks(K, bits, tile), want))


def _check(x, codes, scales, codebook, block, bits):
    if bits not in (4, 8):
        raise ValueError(f"dequant_matmul: bits must be 4 or 8, got {bits}")
    if block not in BLOCKS:
        raise ValueError(f"dequant_matmul: block must be one of {BLOCKS}, "
                         f"got {block}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dequant_matmul: x must be bf16 or f32, got "
                        f"{x.dtype}")
    if codes.dtype != torch.uint8 or scales.dtype != torch.bfloat16 \
            or codebook.dtype != torch.float32:
        raise TypeError(
            "dequant_matmul: expected uint8 codes, bf16 scales and an f32 "
            f"codebook, got {codes.dtype}, {scales.dtype}, {codebook.dtype}")
    tensors = {"x": x, "codes": codes, "scales": scales, "codebook": codebook}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"dequant_matmul: {name} is on {t.device}; every "
                             f"operand must be on the CUDA device of x "
                             f"({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"dequant_matmul: {name} must be contiguous")
    if x.ndim not in (2, 3) or codes.ndim != x.ndim or scales.ndim != x.ndim:
        raise ValueError(
            f"dequant_matmul: x {tuple(x.shape)}, codes {tuple(codes.shape)} "
            f"and scales {tuple(scales.shape)} must all be 2-D or all 3-D")
    if codebook.ndim != 1 or not 1 <= codebook.numel() <= (16 if bits == 4
                                                             else 256):
        raise ValueError(f"dequant_matmul: codebook of {codebook.numel()} "
                         f"points does not fit {bits}-bit codes")
    *lead, M, K = x.shape
    N = codes.shape[-1]
    pack = 2 if bits == 4 else 1
    if tuple(codes.shape) != (*lead, K // pack, N) or K % pack:
        raise ValueError(f"dequant_matmul: codes {tuple(codes.shape)} do not "
                         f"match x {tuple(x.shape)} at bits={bits}")
    if N % block or tuple(scales.shape) != (*lead, K, N // block):
        raise ValueError(f"dequant_matmul: scales {tuple(scales.shape)} do "
                         f"not match codes {tuple(codes.shape)} at "
                         f"block={block}")
    if M == 0 or K == 0:
        raise ValueError(f"dequant_matmul: empty operand x {tuple(x.shape)}")
    if codes.data_ptr() % 4:
        raise ValueError("dequant_matmul: codes must be 4-byte aligned")


def dequant_matmul_cuda(x, codes, scales, codebook, block: int = 128,
                        bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; see the module docstring."""
    global launches
    lib = build.load_library("dequant_matmul")
    _check(x, codes, scales, codebook, block, bits)
    lead = x.ndim == 3
    E = x.shape[0] if lead else 1
    M, K = x.shape[-2:]
    N = codes.shape[-1]
    tile = nibble_k_tile(K) if bits == 4 else K
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    splits = choose_splits(E, M, K, N, bits, tile, m_tile(M),
                           _sm_count(x.device.index))
    partial = (torch.empty(splits * E * M * N, dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dequant_matmul_launch(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        codebook.data_ptr(), out.data_ptr(),
        partial.data_ptr() if partial is not None else None,
        int(x.dtype == torch.bfloat16), E, M, K, N, block, bits, tile,
        codebook.numel(), splits, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dequant_matmul: CUDA launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    return out
