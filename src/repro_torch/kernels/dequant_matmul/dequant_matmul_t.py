"""Wrapper of the CUDA ``dequant_matmul_t`` kernel (``kernels/csrc``).

``dequant_matmul_t_cuda(x, codes, scales, codebook, block, bits)`` computes
``x (M, D) @ dequant(codes, scales).T -> (M, V)`` on the card (the tied
unembed): checks every operand, allocates the output with ``torch.empty``,
launches on the current stream and raises on a non-zero ``cudaError_t``. It
never falls back to the plain version. ``launches`` counts the launches
made.

bf16 x runs the tensor-core kernel: one launch, one warp per 16 byte rows
walking all of D (no K split, so two calls are bitwise equal), with the
byte -> bf16x2 table of ``dequant_matmul`` (``_table``). f32 x, and bf16 x
whose 8 staged rows do not fit the tensor-core kernel's shared memory (D
above about 12k), run the CUDA-core kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.nibble import nibble_k_tile
from repro_torch.kernels import build
from repro_torch.kernels.dequant_matmul.dequant_matmul import _table

# Launches made by this module's kernels since the count was last set to 0.
launches = 0

# CUDA-core kernel (csrc dequant_matmul_t_kernel)
MAX_M_TILE = 32                 # csrc: templates for 1, 2, 4, ..., 32 rows
SMEM_BUDGET = 200 * 1024        # bytes of x a block may stage (of 227 KB)
# bf16 tensor-core kernel (csrc tc::kernel)
TC_TABLE_BYTES = 256 * 32 * 4   # the byte table, one copy per bank
TC_SMEM_MAX = 227 * 1024        # dynamic shared memory a block may take
TC_BLOCKS_PER_SM = 2            # __launch_bounds__(256, 2)
TC_WARP_ROWS = 16               # byte rows a warp tile


def m_tile(M: int, D: int) -> int:
    """Rows of x a block stages: the power of two >= M, at most 32, halved
    until (256 + rows * D) f32 fit the shared-memory budget."""
    mt = 1
    while mt < M and mt < MAX_M_TILE:
        mt *= 2
    while mt > 1 and (256 + mt * D) * 4 > SMEM_BUDGET:
        mt //= 2
    return mt


def n_blocks(byte_rows: int, smem_bytes: int, n_sm: int) -> int:
    """Blocks of 8 warps walking the byte rows grid-stride: as many as fit
    on the card at once (shared memory bound, at most 4 per SM), never more
    than there are rows for."""
    per_sm = max(1, min(4, SMEM_BUDGET // smem_bytes))
    return max(1, min(-(-byte_rows // 8), per_sm * n_sm))


def tc_smem(nt: int, D: int) -> int:
    """Shared bytes of a tensor-core block: the table and 8*nt rows of x
    (row stride D rounded up to 64, plus 4, in bf16)."""
    return TC_TABLE_BYTES + 2 * 8 * nt * (-(-D // 64) * 64 + 4)


def tc_n_tiles(M: int, D: int) -> int:
    """n8-tiles of tokens a tensor-core block takes: ceil(M / 8) rounded up
    to 1, 2 or 4, halved while its x does not fit in shared memory; 0 where
    even one does not (the CUDA-core kernel serves that D)."""
    nt = 1 if M <= 8 else 2 if M <= 16 else 4
    while nt > 1 and tc_smem(nt, D) > TC_SMEM_MAX:
        nt //= 2
    return nt if tc_smem(nt, D) <= TC_SMEM_MAX else 0


def code_vec(ptr: int, D: int) -> int:
    """Bytes of one code load (16, 8 or 4): the widest that divides both
    the codes' address and D (every byte row starts at a multiple of D)."""
    for vec in (16, 8):
        if ptr % vec == 0 and D % vec == 0:
            return vec
    return 4


def tc_blocks(byte_rows: int, n_sm: int) -> int:
    """Blocks of 8 warps walking the 16-row warp tiles grid-stride: one
    wave of two per SM, never more than there are tiles for."""
    return max(1, min(-(-byte_rows // (8 * TC_WARP_ROWS)),
                      TC_BLOCKS_PER_SM * n_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check(x, codes, scales, codebook, block, bits):
    name = "dequant_matmul_t"
    if bits not in (4, 8):
        raise ValueError(f"{name}: bits must be 4 or 8, got {bits}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bf16 or f32, got {x.dtype}")
    if codes.dtype != torch.uint8 or scales.dtype != torch.bfloat16 \
            or codebook.dtype != torch.float32:
        raise TypeError(
            f"{name}: expected uint8 codes, bf16 scales and an f32 codebook, "
            f"got {codes.dtype}, {scales.dtype}, {codebook.dtype}")
    for label, t in {"x": x, "codes": codes, "scales": scales,
                     "codebook": codebook}.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}; every "
                             f"operand must be on the CUDA device of x "
                             f"({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if x.ndim != 2 or codes.ndim != 2 or scales.ndim != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)}, codes "
                         f"{tuple(codes.shape)} and scales "
                         f"{tuple(scales.shape)} must be 2-D")
    if codebook.ndim != 1 or not 1 <= codebook.numel() <= (16 if bits == 4
                                                             else 256):
        raise ValueError(f"{name}: codebook of {codebook.numel()} points "
                         f"does not fit {bits}-bit codes")
    M, D = x.shape
    V = codes.shape[0] * (2 if bits == 4 else 1)
    if M == 0 or D == 0 or V == 0:
        raise ValueError(f"{name}: empty operand x {tuple(x.shape)}, codes "
                         f"{tuple(codes.shape)}")
    if codes.shape[1] != D or D % 4:
        raise ValueError(f"{name}: codes {tuple(codes.shape)} do not match "
                         f"x {tuple(x.shape)} (D must also divide by 4)")
    if block % 4 or D % block or tuple(scales.shape) != (V, D // block):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} do not match "
                         f"codes {tuple(codes.shape)} at block={block}")
    if codes.data_ptr() % 4:
        raise ValueError(f"{name}: codes must be 4-byte aligned")


def tc_blocks_per_sm(bits: int, M: int, D: int, block: int) -> int:
    """Blocks of the tensor-core instance that serves ``M`` tokens at this
    D and block resident on one SM (on the card). Its registers and spills
    are in nvcc's ``-Xptxas -v`` report (``build.build(verbose=True)``)."""
    lib = build.load_library("dequant_matmul_t")
    fn = lib.dequant_matmul_t_tc_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int()
    err = fn(bits, tc_n_tiles(M, D), block, D, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"dequant_matmul_t: occupancy query failed with "
                           f"cudaError_t {err}")
    return blocks.value


def dequant_matmul_t_cuda(x, codes, scales, codebook, block: int = 128,
                          bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; see the module docstring."""
    global launches
    lib = build.load_library("dequant_matmul_t")
    _check(x, codes, scales, codebook, block, bits)
    M, D = x.shape
    V = codes.shape[0] * (2 if bits == 4 else 1)
    tile = nibble_k_tile(V) if bits == 4 else V
    n_sm = _sm_count(x.device.index)
    nt = tc_n_tiles(M, D) if x.dtype == torch.bfloat16 else 0
    if nt:
        table = _table(codebook, bits)
        geometry = (8 * nt, tc_blocks(codes.shape[0], n_sm),
                    code_vec(codes.data_ptr(), D))
    else:
        table = None
        mt = m_tile(M, D)
        geometry = (mt, n_blocks(codes.shape[0], (256 + mt * D) * 4, n_sm), 0)
    out = torch.empty(M, V, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dequant_matmul_t_launch(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        codebook.data_ptr(), None if table is None else table.data_ptr(),
        out.data_ptr(), int(x.dtype == torch.bfloat16), M, D, V, block, bits,
        tile, codebook.numel(), *geometry, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dequant_matmul_t: CUDA launch failed with "
                           f"cudaError_t {err}")
    launches += 1
    return out
