"""Wrapper of the CUDA ``dequant_matmul`` kernels (``kernels/csrc``).

``dequant_matmul_cuda(x, codes, scales, codebook, block, bits)`` computes
``x (*lead, M, K) @ dequant(codes, scales) -> (*lead, M, N)`` on the card:
checks every operand, allocates the output with ``torch.empty``, launches on
the current stream and raises on a non-zero ``cudaError_t``. It never falls
back to the plain version. ``launches`` counts the calls that launched,
``lead_launches`` those of them with an expert lead dim (3-D x: the MoE
expert stacks, E experts in one launch).

bf16 x runs the tensor-core kernel: one launch per call, its K splits
combined inside the launch through a per-(device, stream) workspace that
this module owns (f32 partials and a counter per column tile, which the
kernel leaves at 0), with a 256-entry byte -> bf16x2 table
(``dequant_table``) built once per codebook tensor. f32 x runs the CUDA-core
kernel, whose K splits a second kernel sums. The per-shape geometry is
cached.
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch

from repro_torch.core.nibble import nibble_k_tile
from repro_torch.kernels import build

# Calls of dequant_matmul_cuda that launched, since the count was last set
# to 0, and those of them with a lead dim.
launches = 0
lead_launches = 0

BLOCKS = (32, 64, 128)
# f32 kernel (csrc dequant_matmul_kernel)
TILE_N = 128      # output columns per block (csrc kTileN)
CHUNK = 128       # code rows per staged chunk (csrc kChunk)
# bf16 tensor-core kernel (csrc mma::kernel)
MMA_WARPS = 8


def m_tile(M: int) -> int:
    """Rows per block of the f32 kernel: the power of two >= M, at most 16
    (csrc)."""
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
    """K splits of the f32 kernel: enough blocks for two per SM, never more
    splits than chunks of code rows."""
    base = -(-N // TILE_N) * -(-M // m_tile) * E
    want = -(-2 * n_sm // base)
    return max(1, min(_n_chunks(K, bits, tile), want))


class MmaGeometry(NamedTuple):
    """Launch shape of the tensor-core kernel for one call shape."""
    vec: int          # bytes per code load (4 or 8) = columns a lane chunk
    m_tile: int       # tokens per block: 8 * ceil(M / 8), at most 32
    col_tiles: int    # blocks along N (16 * vec columns each)
    m_tiles: int      # blocks along M
    splits: int       # K splits, combined in the launch in split order
    chunks: int       # chunks of 64 k-pairs

    @property
    def tiles(self) -> int:
        return self.col_tiles * self.m_tiles

    def workspace_floats(self, E: int) -> int:
        if self.splits == 1:
            return 0
        return self.splits * E * self.tiles * self.m_tile * 16 * self.vec

    def counters(self, E: int) -> int:
        return 0 if self.splits == 1 else E * self.tiles


def mma_geometry(E: int, M: int, K: int, N: int, bits: int, n_sm: int,
                 max_vec: int = 8) -> MmaGeometry:
    """Tile and split choice of the tensor-core kernel.

    ``nt = ceil(M / 8)`` n8-tiles (at most 4). ``vec`` bytes per code load:
    8 for up to 8 tokens and N > 2048, else 4 (more column tiles for the
    narrow weights, 64 accumulators a lane at 32 tokens); 4 where the codes
    are not 8-byte aligned (``max_vec``). K is split into as many splits as
    one wave of blocks holds (two blocks per SM, the kernel's occupancy),
    never more than there are 64-pair chunks."""
    nt = 1 if M <= 8 else 2 if M <= 16 else 4
    vec = 8 if nt == 1 and N > 2048 and max_vec >= 8 else 4
    mt = 8 * nt
    col_tiles = -(-N // (16 * vec))
    m_tiles = -(-M // mt)
    pairs = K // 2 if bits == 4 else -(-K // 2)
    chunks = -(-pairs // (MMA_WARPS * 8))
    base = col_tiles * m_tiles * E
    splits = max(1, min(chunks, 2 * n_sm // base))
    return MmaGeometry(vec, mt, col_tiles, m_tiles, splits, chunks)


def dequant_table(codebook: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernel's 256-entry dequantisation table, as int32 words on the
    codebook's device: byte b -> bf16x2 ``{cb[b & 15], cb[b >> 4]}`` (low
    half, high half) at ``bits=4``, so one nibble byte gives the two weights
    of its k-pair; bf16 ``cb[b]`` in the low half at ``bits=8``. The
    codebook is cast to bf16 (round to nearest); entries past its length
    are 0."""
    n = 16 if bits == 4 else 256
    cb = torch.zeros(n, dtype=torch.float32, device=codebook.device)
    cb[:codebook.numel()] = codebook.float()
    half = cb.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    b = torch.arange(256, device=codebook.device)
    word = half[b & 15] | (half[b >> 4] << 16) if bits == 4 else half
    return (word - ((word >> 31) << 32)).to(torch.int32)


# id(codebook) -> (weakref to it, its _version, bits, table)
_tables: dict = {}


def _table(codebook: torch.Tensor, bits: int) -> torch.Tensor:
    """``dequant_table`` of this codebook tensor, built at its first use and
    rebuilt if the tensor is written in place. An inference tensor (made
    under ``torch.inference_mode``) has no version counter to show such a
    write, so its table is built anew at every call and never cached."""
    if codebook.is_inference():
        return dequant_table(codebook, bits)
    key = id(codebook)
    hit = _tables.get(key)
    if hit is not None and hit[0]() is codebook and \
            hit[1] == codebook._version and hit[2] == bits:
        return hit[3]
    table = dequant_table(codebook, bits)
    _tables[key] = (weakref.ref(codebook, lambda _, k=key: _tables.pop(k,
                                                                      None)),
                    codebook._version, bits, table)
    return table


# (device index, stream) -> [f32 workspace, int32 counters (all 0)]
_workspaces: dict = {}


def _workspace(device: torch.device, stream: int, floats: int,
               counters: int):
    """This stream's scratch, grown to at least the given sizes. The kernel
    returns every counter to 0, so zeros are written only when it grows."""
    ws = _workspaces.get((device.index, stream))
    if ws is None or ws[0].numel() < floats or ws[1].numel() < counters:
        old = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = [torch.empty(max(floats, old[0], 1), dtype=torch.float32,
                          device=device),
              torch.zeros(max(counters, old[1], 1), dtype=torch.int32,
                          device=device)]
        _workspaces[(device.index, stream)] = ws
    return ws


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


@functools.lru_cache(maxsize=4096)
def _geometry(bf16: bool, E: int, M: int, K: int, N: int, bits: int,
              max_vec: int, device_index: int):
    """(tile, geometry or f32 splits, workspace floats, counters) of one
    call shape."""
    tile = nibble_k_tile(K) if bits == 4 else K
    n_sm = _sm_count(device_index)
    if bf16:
        geo = mma_geometry(E, M, K, N, bits, n_sm, max_vec)
        return tile, geo, geo.workspace_floats(E), geo.counters(E)
    splits = choose_splits(E, M, K, N, bits, tile, m_tile(M), n_sm)
    return tile, splits, (splits * E * M * N if splits > 1 else 0), 0


def launch(x, codes, scales, codebook, out, block: int, bits: int,
           tile: int, geometry, ws_floats: int, n_counters: int) -> None:
    """One launch into ``out`` with a given geometry (``MmaGeometry`` for
    bf16 x, the split count for f32 x); raises on a CUDA error."""
    lib = build.load_library("dequant_matmul")
    bf16 = x.dtype == torch.bfloat16
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    N = codes.shape[-1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws, counters = _workspace(x.device, stream, ws_floats, n_counters)
    table = _table(codebook, bits) if bf16 else None
    vec, splits = ((geometry.vec, geometry.splits) if bf16
                   else (4, geometry))
    err = lib.dequant_matmul_launch(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        codebook.data_ptr(), table.data_ptr() if bf16 else None,
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), int(bf16), E, M,
        K, N, block, bits, tile, codebook.numel(), vec, splits,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"dequant_matmul: CUDA launch failed with "
                           f"cudaError_t {err}")


def mma_info(bits: int, M: int, vec: int) -> dict:
    """Registers per thread, dynamic shared bytes per block, blocks resident
    per SM, spill bytes and ring depth of the tensor-core instance that
    serves ``M`` tokens with ``vec``-byte code loads (on the card)."""
    lib = build.load_library("dequant_matmul")
    fn = lib.dequant_matmul_mma_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    nt = 1 if M <= 8 else 2 if M <= 16 else 4
    err = fn(bits, nt, vec, out)
    if err != 0:
        raise RuntimeError(f"dequant_matmul: occupancy query failed with "
                           f"cudaError_t {err}")
    return dict(registers=out[0], smem_bytes=out[1], blocks_per_sm=out[2],
                spill_bytes=out[3], ring_depth=out[4])


def dequant_matmul_cuda(x, codes, scales, codebook, block: int = 128,
                        bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; see the module docstring."""
    global launches, lead_launches
    build.load_library("dequant_matmul")
    _check(x, codes, scales, codebook, block, bits)
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    N = codes.shape[-1]
    ptr = codes.data_ptr()
    max_vec = 8 if ptr % 8 == 0 else 4
    tile, geo, ws_floats, n_counters = _geometry(
        x.dtype == torch.bfloat16, E, M, K, N, bits, max_vec,
        x.device.index)
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    launch(x, codes, scales, codebook, out, block, bits, tile, geo,
           ws_floats, n_counters)
    launches += 1
    lead_launches += x.ndim == 3
    return out
