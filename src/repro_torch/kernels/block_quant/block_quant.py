"""Wrapper of the CUDA ``block_quant`` kernel (``kernels/csrc``).

``block_quant_cuda(x, codebook, block, pack=, out=, rows=)`` quantises x
(rows, cols) on the card: per (row, block) an absmax scale rounded to bf16
away from zero and uint8 codes, as ``ref.block_quant_ref`` computes them,
bit for bit. ``pack=True`` stores 4-bit codes pairwise along the row
(``ref.pack_pairs``); ``out=(codes, scales)`` with ``rows`` (int64, one
output row per input row) writes into existing buffers — the quantised KV
cache — instead of allocating.

``block_quant_kv_cuda(k, v, codebook, block, pack=, out_k=, out_v=, rows=)``
is the served KV write: a layer's fresh k and v rows, quantised into their
two caches at the same ``rows``, in one launch of the same kernel (it reads
k and v through two pointers; nothing is stacked or copied).

Both check every operand (once per call, also for a pair), launch on the
current stream and raise on a non-zero ``cudaError_t``; they never fall back
to the plain version. ``launches`` counts the launches of both.
``launch_floor()`` launches an empty kernel through the same route, to time
the launch floor; it counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# Launches made by block_quant_cuda and block_quant_kv_cuda since the count
# was last set to 0.
launches = 0

NAME = "block_quant"


def _check_x(x, block):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{NAME}: x must be bf16 or f32, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] == 0 or block < 1 or x.shape[1] % block:
        raise ValueError(f"{NAME}: x {tuple(x.shape)} must be 2-D, non-empty "
                         f"and tile by block={block}")


def _check_codebook(codebook, block, pack):
    if codebook.dtype != torch.float32 or codebook.ndim != 1 \
            or not 2 <= codebook.numel() <= 256:
        raise ValueError(f"{NAME}: codebook must be 1-D f32 with 2..256 "
                         "points")
    if pack and (codebook.numel() > 16 or block % 2):
        raise ValueError(f"{NAME}: pack needs a codebook of <= 16 points and "
                         f"an even block, got {codebook.numel()} and {block}")


def _check_rows(x, rows):
    if rows is None or rows.dtype != torch.int64 \
            or rows.shape != (x.shape[0],):
        raise ValueError(f"{NAME}: out needs rows, int64 of shape "
                         f"({x.shape[0]},)")


def _check_out(label, x, block, pack, out):
    """``out`` = (codes, scales) holds whole output rows of x's width."""
    codes, scales = out
    if codes.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"{NAME}: {label} must be uint8 codes and f32 "
                        "scales")
    width = x.shape[1] // 2 if pack else x.shape[1]
    n_out = codes.numel() // width if width else 0
    if codes.numel() != n_out * width or \
            scales.numel() != n_out * (x.shape[1] // block):
        raise ValueError(f"{NAME}: {label} codes {tuple(codes.shape)} and "
                         f"scales {tuple(scales.shape)} do not hold rows of "
                         f"{width} bytes and {x.shape[1] // block} scales")


def _check_device(x, tensors):
    for label, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{NAME}: {label} is on {t.device}; every "
                             f"operand must be on the CUDA device of x "
                             f"({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {label} must be contiguous")


def _launch(lib, xs, outs, codebook, block, pack, rows):
    """One launch over the checked tensors ``xs`` (one or two) into
    ``outs``; 16-byte loads and whole-chunk code stores where every x and
    code buffer is aligned for them."""
    global launches
    x = xs[0]
    n, cols = x.shape
    per = 16 // x.element_size()            # elements in a 16-byte chunk
    store = per // 2 if pack else per       # code bytes of one chunk
    vec = block % per == 0 and all(t.data_ptr() % 16 == 0 for t in xs) \
        and all(c.data_ptr() % store == 0 for c, _ in outs)
    two = len(xs) == 2
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.block_quant_launch(
        x.data_ptr(), xs[1].data_ptr() if two else None,
        outs[0][0].data_ptr(), outs[1][0].data_ptr() if two else None,
        outs[0][1].data_ptr(), outs[1][1].data_ptr() if two else None,
        rows.data_ptr() if rows is not None else None, codebook.data_ptr(),
        int(x.dtype == torch.bfloat16), len(xs), n, cols, block,
        codebook.numel(), int(pack), int(vec), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{NAME}: CUDA launch failed with cudaError_t "
                           f"{err}")
    launches += 1


def block_quant_cuda(x, codebook, block: int = 128, *, pack: bool = False,
                     out=None, rows=None):
    """Launch the CUDA kernel; returns (codes, scales). See the module
    docstring. The output rows named in ``rows`` must be distinct and in
    range; that is the caller's contract, as for any scatter."""
    lib = build.load_library(NAME)
    _check_x(x, block)
    _check_codebook(codebook, block, pack)
    tensors = {"x": x, "codebook": codebook}
    if out is not None:
        _check_out("out", x, block, pack, out)
        _check_rows(x, rows)
        tensors.update(codes=out[0], scales=out[1], rows=rows)
    elif rows is not None:
        raise ValueError(f"{NAME}: rows given without out")
    _check_device(x, tensors)
    if out is None:
        n, cols = x.shape
        out = (torch.empty(n, cols // 2 if pack else cols, dtype=torch.uint8,
                           device=x.device),
               torch.empty(n, cols // block, dtype=torch.float32,
                           device=x.device))
    _launch(lib, (x,), (out,), codebook, block, pack, rows)
    return out


def block_quant_kv_cuda(k, v, codebook, block: int, *, pack: bool = False,
                        out_k, out_v, rows):
    """Quantise k and v (rows, cols), alike in shape and type, into
    ``out_k`` and ``out_v`` (each (codes, scales)) at the shared output
    ``rows``, in one launch; returns (out_k, out_v). The rows must be
    distinct and in range (the caller's contract)."""
    lib = build.load_library(NAME)
    _check_x(k, block)
    if v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"{NAME}: v {tuple(v.shape)} {v.dtype} must match k "
                         f"{tuple(k.shape)} {k.dtype}")
    _check_codebook(codebook, block, pack)
    _check_out("out_k", k, block, pack, out_k)
    _check_out("out_v", k, block, pack, out_v)
    _check_rows(k, rows)
    _check_device(k, {"k": k, "v": v, "codebook": codebook,
                      "out_k codes": out_k[0], "out_k scales": out_k[1],
                      "out_v codes": out_v[0], "out_v scales": out_v[1],
                      "rows": rows})
    _launch(lib, (k, v), (out_k, out_v), codebook, block, pack, rows)
    return out_k, out_v


def launch_floor():
    """Launch an empty kernel on the current stream through the same ctypes
    route (the launch floor of a launch-bound kernel's time); counts
    nothing."""
    lib = build.load_library(NAME)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.block_quant_floor_launch(ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{NAME}: empty launch failed with cudaError_t "
                           f"{err}")
