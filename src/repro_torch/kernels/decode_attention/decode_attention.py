"""Wrapper of the CUDA ``decode_attention_quant`` kernel (``kernels/csrc``).

``decode_attention_quant_cuda(q, k_codes, k_scales, v_codes, v_scales,
codebook, q_positions, window, ring=, bits=)`` computes masked decode
attention straight from block-scaled KV codes on the card (see
``ref.decode_attention_quant_ref`` for the function). It checks every
operand, allocates the output (and, when S is split across blocks, the f32
partials) with ``torch.empty``, launches on the current stream and raises on
a non-zero ``cudaError_t``; it never falls back to the plain version.
``launches`` counts the calls that launched it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# Launches made by decode_attention_quant_cuda since the count was last set
# to 0.
launches = 0

CHUNK = 32        # cache slots per online-softmax step (csrc kChunk)
ROW_TILE = 32     # query rows per block (csrc kRowTile)
MAX_HD = 256


def choose_splits(B: int, K: int, rows: int, S: int, n_sm: int) -> int:
    """Splits of S across blocks: enough blocks for two per SM, never more
    splits than 32-slot chunks."""
    base = B * K * -(-rows // ROW_TILE)
    return max(1, min(-(-S // CHUNK), -(-2 * n_sm // base)))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
           bits):
    name = "decode_attention_quant"
    if bits not in (4, 8):
        raise ValueError(f"{name}: bits must be 4 or 8, got {bits}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q must be bf16 or f32, got {q.dtype}")
    if q.ndim != 4:
        raise ValueError(f"{name}: q must be (B, T, H, hd), got "
                         f"{tuple(q.shape)}")
    B, T, H, hd = q.shape
    if k_codes.ndim != 4:
        raise ValueError(f"{name}: codes must be (B, S, K, hdc), got "
                         f"{tuple(k_codes.shape)}")
    S, K = k_codes.shape[1], k_codes.shape[2]
    hdc = hd // 2 if bits == 4 else hd
    if 0 in (B, T, H, S, K) or H % K or hd % 4 or hd > MAX_HD:
        raise ValueError(f"{name}: q {tuple(q.shape)} and codes "
                         f"{tuple(k_codes.shape)}: need H % K == 0, hd <= "
                         f"{MAX_HD} dividing by 4 and no empty dim")
    for label, t, shape, dt in (
            ("k_codes", k_codes, (B, S, K, hdc), torch.uint8),
            ("v_codes", v_codes, (B, S, K, hdc), torch.uint8),
            ("k_scales", k_scales, (B, S, K, 1), torch.float32),
            ("v_scales", v_scales, (B, S, K, 1), torch.float32),
            ("q_positions", q_positions, (B, T), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: {label} is {tuple(t.shape)} "
                             f"{t.dtype}, expected {shape} {dt}")
    if codebook.dtype != torch.float32 or codebook.ndim != 1 or \
            not 1 <= codebook.numel() <= (16 if bits == 4 else 256):
        raise ValueError(f"{name}: codebook of {codebook.numel()} "
                         f"{codebook.dtype} points does not fit {bits}-bit "
                         "codes")
    for label, t in {"q": q, "k_codes": k_codes, "k_scales": k_scales,
                     "v_codes": v_codes, "v_scales": v_scales,
                     "codebook": codebook,
                     "q_positions": q_positions}.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}; every "
                             f"operand must be on the CUDA device of q "
                             f"({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    align = 2 if bits == 4 else 4
    if k_codes.data_ptr() % align or v_codes.data_ptr() % align:
        raise ValueError(f"{name}: codes must be {align}-byte aligned")


def decode_attention_quant_cuda(q, k_codes, k_scales, v_codes, v_scales,
                                codebook, q_positions, window: int = 0, *,
                                ring: bool = False,
                                bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; see the module docstring. ``window`` is a
    Python int (0 = global)."""
    global launches
    lib = build.load_library("decode_attention")
    _check(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
           bits)
    B, T, H, hd = q.shape
    S, K = k_codes.shape[1], k_codes.shape[2]
    rows = T * (H // K)
    splits = choose_splits(B, K, rows, S, _sm_count(q.device.index))
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if splits > 1:
        part_ml = torch.empty(splits * B * K * rows * 2, dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty(splits * B * K * rows * hd,
                               dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_quant_launch(
        q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(),
        v_codes.data_ptr(), v_scales.data_ptr(), codebook.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(),
        part_ml.data_ptr() if part_ml is not None else None,
        part_acc.data_ptr() if part_acc is not None else None,
        int(q.dtype == torch.bfloat16), B, T, H, K, hd, S, bits,
        codebook.numel(), int(window), int(ring), splits, float(hd ** -0.5),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"decode_attention_quant: CUDA launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    return out
