"""Wrapper of the CUDA ``decode_attention_quant`` kernel (``kernels/csrc``).

``decode_attention_quant_cuda(q, k_codes, k_scales, v_codes, v_scales,
codebook, q_positions, window, ring=, bits=)`` computes masked decode
attention straight from block-scaled KV codes on the card (see
``ref.decode_attention_quant_ref`` for the function). It checks every
operand, allocates the output with ``torch.empty_like``, launches once on
the current stream and raises on a non-zero ``cudaError_t``; it never falls
back to the plain version. ``launches`` counts the calls that launched it.

Decode rows (up to 8 query rows a kv head, or f32 q) run the CUDA-core
kernel; bf16 prefill chunks of more rows run the tensor-core kernel
(``geometry``). S is split across the blocks of one thread block cluster a
group of query rows, which combine their partials through distributed
shared memory in split order, so reruns are bitwise equal. The per-shape
geometry is cached.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

# Launches made by decode_attention_quant_cuda since the count was last set
# to 0.
launches = 0

MAX_HD = 256
MAX_WARPS = 8       # warps a block of the CUDA-core kernel (csrc kMaxWarps)
MAX_CLUSTER = 16    # blocks a cluster: the most splits (csrc kMaxCluster)
PORTABLE_CLUSTER = 8  # the cluster size every sm_90 card can schedule
MMA_HD = (64, 128, 256)   # head dims of the tensor-core kernel
MMA_CHUNK = 64      # slots a chunk of the tensor-core kernel (csrc tc::kChunk)


class Geometry(NamedTuple):
    """Launch shape of one call shape. ``path`` 0 is the CUDA-core kernel
    (csrc ``attn_rows_kernel``): tiles of ``row_tile`` (4 or 8) query rows,
    batches of ``32 // row_tile`` slots a warp. ``path`` 1 the tensor-core
    kernel (csrc ``attn_mma_kernel``): tiles of 16 rows, 8 warps, chunks of
    ``MMA_CHUNK`` slots. A group is (b, kv head, row tile); S is split into
    ``splits`` blocks a group of ``warps`` warps, one cluster."""
    path: int
    row_tile: int
    row_tiles: int
    warps: int
    splits: int


def geometry(B: int, T: int, H: int, K: int, S: int, n_sm: int, *,
             hd: int = 0, tensor_cores: bool = False,
             max_cluster: int = MAX_CLUSTER) -> Geometry:
    """Path, tiles, warps and splits of one call shape.

    ``tensor_cores`` (bf16 q, codes 16-byte aligned) with more than 8 query
    rows a kv head and hd 64, 128 or 256 takes the tensor-core kernel, with
    the 64-slot chunks spread as evenly as the splits allow. Otherwise the
    CUDA-core kernel: rows in tiles of 4 (up to 4 rows: a decode step of 4
    heads a kv head) or 8, 8 warps a block (fewer where S has fewer
    batches), a warp takes ``32 // row_tile`` slots at a time, and S is
    split so that each warp has one batch where the splits allow. Splits
    stay within ``max_cluster`` blocks and one block per SM a group; past
    that blocks loop over chunks or batches."""
    rows = T * (H // K)
    tc = tensor_cores and rows > 8 and hd in MMA_HD
    row_tile = 16 if tc else 4 if rows <= 4 else 8
    row_tiles = -(-rows // row_tile)
    cap = max(1, min(max_cluster, n_sm // (B * K * row_tiles)))
    if tc:
        chunks = -(-S // MMA_CHUNK)
        return Geometry(1, 16, row_tiles, 8, -(-chunks // -(-chunks // cap)))
    batches = -(-S // (32 // row_tile))
    w = min(MAX_WARPS, batches)
    return Geometry(0, row_tile, row_tiles, w, min(cap, -(-batches // w)))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def instance_info(geo: Geometry, bits: int, bf16: bool, hd: int) -> dict:
    """Of the instance ``geo`` runs on the current card: ``clusters``, how
    many clusters of ``geo.splits`` blocks the card can hold at once (0:
    none can be scheduled), and ``smem_bytes``, the dynamic shared memory
    of one block."""
    lib = build.load_library("decode_attention")
    info = (ctypes.c_int * 2)()
    err = lib.decode_attention_instance_info(
        geo.path, bits, int(bf16), geo.row_tile, hd, geo.warps, geo.splits,
        info)
    if err != 0:
        raise RuntimeError(f"decode_attention_quant: instance query failed "
                           f"with cudaError_t {err}")
    return dict(clusters=info[0], smem_bytes=info[1])


@functools.lru_cache(maxsize=4096)
def _geometry(B, T, H, K, S, hd, bits, bf16, tensor_cores,
              device_index) -> Geometry:
    """``geometry`` on this card: clusters of more than ``PORTABLE_CLUSTER``
    blocks only where the card can schedule them."""
    n_sm = _sm_count(device_index)
    geo = geometry(B, T, H, K, S, n_sm, hd=hd, tensor_cores=tensor_cores)
    if geo.splits > PORTABLE_CLUSTER and \
            instance_info(geo, bits, bf16, hd)["clusters"] < 1:
        geo = geometry(B, T, H, K, S, n_sm, hd=hd, tensor_cores=tensor_cores,
                       max_cluster=PORTABLE_CLUSTER)
    return geo


def tensor_cores_fit(q, k_codes, v_codes) -> bool:
    """Whether the tensor-core kernel may take these operands: bf16 q and
    codes 16-byte aligned (it reads them in 16-byte vectors)."""
    return (q.dtype == torch.bfloat16 and k_codes.data_ptr() % 16 == 0
            and v_codes.data_ptr() % 16 == 0)


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


def launch(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
           out, window: int, ring: bool, bits: int, geo: Geometry) -> None:
    """One launch into ``out`` with a given geometry; raises on a CUDA
    error. ``q`` must be 16-byte aligned."""
    lib = build.load_library("decode_attention")
    B, T, H, hd = q.shape
    S, K = k_codes.shape[1], k_codes.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_quant_launch(
        q.data_ptr(), k_codes.data_ptr(), k_scales.data_ptr(),
        v_codes.data_ptr(), v_scales.data_ptr(), codebook.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, T, H, K, hd, S, bits,
        codebook.numel(), int(window), int(ring), geo.path, geo.row_tile,
        geo.warps, geo.splits, float(hd ** -0.5), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"decode_attention_quant: CUDA launch failed with "
                           f"cudaError_t {err}")


def decode_attention_quant_cuda(q, k_codes, k_scales, v_codes, v_scales,
                                codebook, q_positions, window: int = 0, *,
                                ring: bool = False,
                                bits: int = 8) -> torch.Tensor:
    """Launch the CUDA kernel; see the module docstring. ``window`` is a
    Python int (0 = global)."""
    global launches
    build.load_library("decode_attention")
    _check(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
           bits)
    if q.data_ptr() % 16:       # the kernel reads q in 16-byte vectors
        q = q.clone()
    B, T, H, hd = q.shape
    S, K = k_codes.shape[1], k_codes.shape[2]
    out = torch.empty_like(q)
    geo = _geometry(B, T, H, K, S, hd, bits, q.dtype == torch.bfloat16,
                    tensor_cores_fit(q, k_codes, v_codes), q.device.index)
    launch(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
           out, window, ring, bits, geo)
    launches += 1
    return out
