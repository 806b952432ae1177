"""Wrapper of the CUDA ``block_quant`` kernel (``kernels/csrc``).

``block_quant_cuda(x, codebook, block, pack=, out=, rows=)`` quantises x
(rows, cols) on the card: per (row, block) an absmax scale rounded to bf16
away from zero and uint8 codes, as ``ref.block_quant_ref`` computes them,
bit for bit. ``pack=True`` stores 4-bit codes pairwise along the row
(``ref.pack_pairs``); ``out=(codes, scales)`` with ``rows`` (int64, one
output row per input row) writes into existing buffers — the quantised KV
cache — instead of allocating. It checks every operand, launches on the
current stream and raises on a non-zero ``cudaError_t``; it never falls back
to the plain version. ``launches`` counts the launches it made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Launches made by block_quant_cuda since the count was last set to 0.
launches = 0

MAX_BLOCKS = 1024


def _check(x, codebook, block, pack, out, rows):
    name = "block_quant"
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bf16 or f32, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] == 0 or block < 1 or x.shape[1] % block:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be 2-D, non-empty "
                         f"and tile by block={block}")
    if codebook.dtype != torch.float32 or codebook.ndim != 1 \
            or not 2 <= codebook.numel() <= 256:
        raise ValueError(f"{name}: codebook must be 1-D f32 with 2..256 "
                         "points")
    if pack and (codebook.numel() > 16 or block % 2):
        raise ValueError(f"{name}: pack needs a codebook of <= 16 points and "
                         f"an even block, got {codebook.numel()} and {block}")
    tensors = {"x": x, "codebook": codebook}
    if out is not None:
        codes, scales = out
        tensors.update(codes=codes, scales=scales)
        if codes.dtype != torch.uint8 or scales.dtype != torch.float32:
            raise TypeError(f"{name}: out must be uint8 codes and f32 scales")
        if rows is None or rows.dtype != torch.int64 \
                or rows.shape != (x.shape[0],):
            raise ValueError(f"{name}: out needs rows, int64 of shape "
                             f"({x.shape[0]},)")
        width = x.shape[1] // 2 if pack else x.shape[1]
        n_out = codes.numel() // width if width else 0
        if codes.numel() != n_out * width or \
                scales.numel() != n_out * (x.shape[1] // block):
            raise ValueError(f"{name}: out codes {tuple(codes.shape)} and "
                             f"scales {tuple(scales.shape)} do not hold rows "
                             f"of {width} bytes and {x.shape[1] // block} "
                             "scales")
        tensors["rows"] = rows
    elif rows is not None:
        raise ValueError(f"{name}: rows given without out")
    for label, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}; every "
                             f"operand must be on the CUDA device of x "
                             f"({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def block_quant_cuda(x, codebook, block: int = 128, *, pack: bool = False,
                     out=None, rows=None):
    """Launch the CUDA kernel; returns (codes, scales). See the module
    docstring. The output rows named in ``rows`` must be distinct and in
    range; that is the caller's contract, as for any scatter."""
    global launches
    lib = build.load_library("block_quant")
    _check(x, codebook, block, pack, out, rows)
    n, cols = x.shape
    if out is None:
        out = (torch.empty(n, cols // 2 if pack else cols, dtype=torch.uint8,
                           device=x.device),
               torch.empty(n, cols // block, dtype=torch.float32,
                           device=x.device))
    codes, scales = out
    blocks = max(1, min(MAX_BLOCKS, -(-n * (cols // block) // 8)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.block_quant_launch(
        x.data_ptr(), codebook.data_ptr(), codes.data_ptr(),
        scales.data_ptr(), rows.data_ptr() if rows is not None else None,
        int(x.dtype == torch.bfloat16), n, cols, block, codebook.numel(),
        int(pack), blocks, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"block_quant: CUDA launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    return codes, scales
