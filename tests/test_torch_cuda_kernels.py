"""On the card: the CUDA kernels of the quantised-KV and tied-unembed path
(``block_quant`` and its paired k + v write ``block_quant_kv``,
``decode_attention_quant``, ``dequant_matmul_t``), and both matmul kernels
at the teacher-forcing M of ``apply`` (M = B·T up to 2048), against
their plain torch versions on the same inputs. Every test here needs an
NVIDIA GPU and skips elsewhere; the file imports nothing of JAX, so it runs
on a machine that has only the port.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.nibble import pack_nibbles
from repro_torch.kernels import ops
from repro_torch.kernels.block_quant import block_quant as bq
from repro_torch.kernels.block_quant.ref import (block_quant_ref, midpoints,
                                                 pack_pairs)
from repro_torch.kernels.decode_attention import decode_attention as daq
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_quant_ref
from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
from repro_torch.kernels.dequant_matmul import dequant_matmul_t as dqmt
from repro_torch.kernels.dequant_matmul.ref import (dequant_matmul_ref,
                                                    dequant_matmul_t_ref)
from repro_torch.models.layers import quantise_kv
from repro_torch.serve.cache import kv_bits, kv_codebook

FMTS = ["q8", "q4"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def hard_rows(rows, hd, cb, seed):
    """Random rows plus the quantiser's edges: a zero row, absmaxes that
    round down in bf16, values exactly on midpoints, a row of one sign."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, hd)).astype(np.float32)
    mids = midpoints(cb).numpy()
    x[1] = 0.0
    x[2, 0] = np.float32(1.0 + 2.0 ** -10)
    x[2, 1:] = np.clip(x[2, 1:], -1, 1)
    x[3] = (mids[rng.integers(0, len(mids), hd)] * 2).astype(np.float32)
    x[3, 0] = np.float32(2.0)
    x[4] = np.abs(x[4])
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("hd,rows", [(32, 24), (64, 8), (256, 32),
                                     (256, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_quant_kernel_bitwise(cuda_device, fmt, hd, rows, dtype):
    cb = kv_codebook(fmt)
    x = hard_rows(rows, hd, cb, seed=rows + hd).to(dtype)
    before = bq.launches
    codes, scales = ops.block_quant(x.to(cuda_device), cb.to(cuda_device),
                                    block=hd)
    torch.cuda.synchronize()
    assert bq.launches == before + 1
    want_c, want_s = block_quant_ref(x, cb, hd)
    assert torch.equal(codes.cpu(), want_c)
    assert torch.equal(scales.cpu(), want_s)
    if fmt == "q4":   # the fused pack + scatter writes the same bytes
        buf_c = torch.zeros(rows + 5, hd // 2, dtype=torch.uint8,
                            device=cuda_device)
        buf_s = torch.zeros(rows + 5, 1, device=cuda_device)
        dest = torch.randperm(rows + 5)[:rows].to(cuda_device)
        ops.block_quant(x.to(cuda_device), cb.to(cuda_device), block=hd,
                        pack=True, out=(buf_c, buf_s), rows=dest)
        assert torch.equal(buf_c[dest].cpu(), pack_pairs(want_c))
        assert torch.equal(buf_s[dest].cpu(), want_s)


def kv_rows_in(fmt, n, hd, seed):
    """k and v (n, hd) f32 whose first rows are the quantiser's edges:
    midpoint ties, a zero row, a round-down absmax, one sign."""
    cb = kv_codebook(fmt)
    order = [3, 1, 2, 4, 0] + list(range(5, max(n, 5)))
    return [hard_rows(max(n, 5), hd, cb, seed + i)[order][:n]
            for i in range(2)]


def check_kv_write(k, v, cb, hd, block, fmt, device):
    """One counted launch of the paired write into two scattered caches,
    bitwise the plain version's at the named rows and nothing elsewhere."""
    n = k.shape[0]
    pack = fmt == "q4"
    slots = n + 7
    dest = torch.randperm(slots, generator=torch.Generator().manual_seed(n))[
        :n]
    bufs = [(torch.zeros(slots, hd // 2 if pack else hd, dtype=torch.uint8,
                         device=device),
             torch.zeros(slots, hd // block, device=device))
            for _ in range(2)]
    before = bq.launches
    ops.block_quant_kv(k, v, cb.to(device), block=block, pack=pack,
                       out_k=bufs[0], out_v=bufs[1], rows=dest.to(device))
    torch.cuda.synchronize()
    assert bq.launches == before + 1
    rest = [r for r in range(slots) if r not in dest.tolist()]
    for x, (c, s) in zip((k, v), bufs):
        want_c, want_s = block_quant_ref(x.cpu(), cb, block)
        assert torch.equal(c[dest].cpu(), pack_pairs(want_c) if pack
                           else want_c)
        assert torch.equal(s[dest].cpu(), want_s)
        assert not c[rest].any() and not s[rest].any()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("rows", [1, 4, 32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_quant_kv_kernel_bitwise(cuda_device, fmt, rows, dtype):
    """The served KV write at gemma3-1b's head dim (256): k and v in one
    launch, codes and scales bitwise the plain version's."""
    cb = kv_codebook(fmt)
    k, v = (x.to(dtype).to(cuda_device)
            for x in kv_rows_in(fmt, rows, 256, seed=rows))
    check_kv_write(k, v, cb, 256, 256, fmt, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("hd,block,offset", [
    (64, 64, 0),      # 8 lanes a row, four rows a warp
    (64, 64, 3),      # rows start mid-tensor: unaligned, scalar loads
    (256, 256, 1),
    (256, 64, 0),     # four blocks a row
    (32, 32, 0), (40, 40, 0),
    (20, 20, 0),      # a block of no whole 16-byte chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_quant_kv_kernel_layouts(cuda_device, fmt, hd, block, offset,
                                       dtype):
    cb = kv_codebook(fmt)
    xs = []
    for x in kv_rows_in(fmt, 12, hd, seed=hd + offset):
        buf = torch.zeros(x.numel() + offset, dtype=dtype,
                          device=cuda_device)
        xs.append(buf[offset:].view(x.shape).copy_(x.to(dtype)))
    check_kv_write(*xs, cb, hd, block, fmt, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("bad,match", [
    ("v_rows", "must match k"), ("v_dtype", "must match k"),
    ("rows_len", "out needs rows"), ("rows_dtype", "out needs rows"),
    ("out_v_short", "do not hold rows"), ("rows_cpu", "CUDA device"),
])
def test_block_quant_kv_kernel_refuses_mismatches(cuda_device, bad, match):
    """A v unlike k, rows that do not name one output row per input row or
    lie elsewhere, and an output that does not hold whole rows raise
    before any launch."""
    d = cuda_device
    kw = dict(k=torch.randn(4, 64, device=d), v=torch.randn(4, 64, device=d),
              out_k=(torch.zeros(8, 64, dtype=torch.uint8, device=d),
                     torch.zeros(8, 1, device=d)),
              out_v=(torch.zeros(8, 64, dtype=torch.uint8, device=d),
                     torch.zeros(8, 1, device=d)),
              rows=torch.arange(4, device=d) * 2)
    kw.update({"v_rows": dict(v=torch.randn(5, 64, device=d)),
               "v_dtype": dict(v=kw["v"].to(torch.bfloat16)),
               "rows_len": dict(rows=torch.arange(3, device=d)),
               "rows_dtype": dict(rows=kw["rows"].int()),
               "out_v_short": dict(out_v=(kw["out_v"][0][:, :63],
                                          kw["out_v"][1])),
               "rows_cpu": dict(rows=kw["rows"].cpu())}[bad])
    before = bq.launches
    with pytest.raises(ValueError, match=match):
        ops.block_quant_kv(kw.pop("k"), kw.pop("v"),
                           kv_codebook("q8").to(d), block=64, **kw)
    assert bq.launches == before


ATTN_CASES = {
    # name: (S, T, window, ring, positions (B, T))
    "linear": (24, 1, 0, False, [[23], [17]]),
    "window": (24, 1, 7, False, [[20], [19]]),
    "ring_wrapped": (24, 1, 8, True, [[27], [40]]),
    "ragged_chunk": (24, 4, 0, False, [[4, 5, 6, 7], [0, 1, 2, 3]]),
    "ring_chunk": (20, 4, 16, True, [[30, 31, 32, 33], [2, 3, 4, 5]]),
    "gemma3_ring": (520, 8, 512, True, [[600 + t for t in range(8)],
                                        [3 + t for t in range(8)]]),
    "gemma3_global": (1032, 1, 0, False, [[1000], [7]]),
}


def attn_inputs(name, fmt, dtype, H=4, K=2, hd=16):
    S, T, window, ring, positions = ATTN_CASES[name]
    if name.startswith("gemma3"):
        H, K, hd = 4, 1, 256
    rng = np.random.default_rng(list(ATTN_CASES).index(name) * 2
                                + FMTS.index(fmt))
    cb = kv_codebook(fmt)
    caches = []
    for _ in range(2):
        dense = torch.from_numpy(
            rng.standard_normal((2, S, K, hd)).astype(np.float32))
        caches += list(quantise_kv(dense, cb, kv_bits(fmt)))
    q = torch.from_numpy(rng.standard_normal((2, T, H, hd)).astype(
        np.float32)).to(dtype)
    qp = torch.tensor(positions, dtype=torch.int32)
    return (q, *caches, cb, qp), dict(window=window, ring=ring,
                                      bits=kv_bits(fmt))


def attn_tol(want, dtype):
    """f32: 1e-5 relative (summation order). bf16: the plain version rounds
    the dequantised K and the scores to bf16 (the reference's casts), the
    kernel keeps them in f32, so 2e-2 of max|out|."""
    scale = float(np.abs(want).max())
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5 * scale)
    return dict(rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel(cuda_device, fmt, name, dtype):
    args, kw = attn_inputs(name, fmt, dtype)
    before = daq.launches
    got = ops.decode_attention_quant(*[a.to(cuda_device) for a in args],
                                     kw["window"], ring=kw["ring"],
                                     bits=kw["bits"])
    torch.cuda.synchronize()
    assert daq.launches == before + 1
    want = decode_attention_quant_ref(*args, **kw).float().numpy()
    assert got.dtype == dtype and np.isfinite(got.float().cpu().numpy()).all()
    np.testing.assert_allclose(got.float().cpu().numpy(), want,
                               **attn_tol(want, dtype))


# (T, S, hd, K) over T in {1, 8, 9} (9 tokens of 4 heads: 36 rows, more
# than one tile) and S in {20, 24, 520, 1031, 1032}, hd and K in turn
SHAPE_CASES = [(T, S, (64, 128, 256)[i % 3], (1, 2)[i // 3 % 2])
               for i, (T, S) in enumerate(
                   (T, S) for T in (1, 8, 9)
                   for S in (20, 24, 520, 1031, 1032))]


def shape_inputs(T, S, hd, K, ring, fmt, dtype, starts=None, window=None):
    """B = 3, H = 4: q, K/V written by quantise_kv, and positions that wrap
    a ring (or reach S - T of a linear cache), sit at the start, and in the
    middle. Linear caches take a window on every other shape."""
    B, H = 3, 4
    rng = np.random.default_rng(T * 7919 + S * 31 + hd + K + 2 * ring)
    cb = kv_codebook(fmt)
    caches = []
    for _ in range(2):
        dense = torch.from_numpy(
            rng.standard_normal((B, S, K, hd)).astype(np.float32))
        caches += list(quantise_kv(dense, cb, kv_bits(fmt)))
    q = torch.from_numpy((rng.standard_normal((B, T, H, hd)) * 2).astype(
        np.float32)).to(dtype)
    if window is None:
        window = max(1, S - T) if ring else (S // 3 if S % 2 else 0)
    if starts is None:
        starts = [S + 37, 3, 2 * S - 5] if ring else [S - T, 0, S // 2]
    qp = torch.tensor(starts, dtype=torch.int32)[:, None] + torch.arange(
        T, dtype=torch.int32)
    return (q, *caches, cb, qp), dict(window=window, ring=ring,
                                      bits=kv_bits(fmt))


def check_attention(args, kw, dtype, device):
    """One counted launch, held to the plain version at attn_tol; a second
    call is bitwise equal. Returns the card's output."""
    before = daq.launches
    got = ops.decode_attention_quant(*[a.to(device) for a in args],
                                     kw["window"], ring=kw["ring"],
                                     bits=kw["bits"])
    torch.cuda.synchronize()
    assert daq.launches == before + 1
    want = decode_attention_quant_ref(*args, **kw).float().numpy()
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    assert np.isfinite(got.float().cpu().numpy()).all()
    np.testing.assert_allclose(got.float().cpu().numpy(), want,
                               **attn_tol(want, dtype))
    again = ops.decode_attention_quant(*[a.to(device) for a in args],
                                       kw["window"], ring=kw["ring"],
                                       bits=kw["bits"])
    assert torch.equal(got, again)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,hd,K", SHAPE_CASES)
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_shapes(cuda_device, T, S, hd, K, ring, fmt,
                                        dtype):
    args, kw = shape_inputs(T, S, hd, K, ring, fmt, dtype)
    check_attention(args, kw, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,hd", [(1, 256), (8, 256), (8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_row_that_sees_no_slot(cuda_device, T, hd,
                                                       dtype):
    """Window 4 past the end of a 24-slot linear cache: the first batch
    row sees no slot, so its answer is the mean of V (every score -1e30),
    as in the reference; the other rows see slots as usual."""
    args, kw = shape_inputs(T, 24, hd, 1, False, "q8", dtype,
                            starts=[40, 10, 3], window=4)
    got = check_attention(args, kw, dtype, cuda_device)
    vc, vs, cb = args[3], args[4], args[5]
    mean_v = (cb[vc.long()] * vs)[0, :, 0].mean(0)
    np.testing.assert_allclose(got[0].float().cpu().numpy(),
                               mean_v.expand(T, 4, hd).numpy(),
                               **attn_tol(mean_v.numpy(), dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(1, 520), (1, 1032), (8, 520), (8, 1032)])
@pytest.mark.parametrize("fmt", FMTS)
def test_decode_attention_kernel_split_reruns_bitwise(cuda_device, T, S,
                                                      fmt):
    """gemma3-1b's shapes split S across the blocks of a cluster: every
    call of a run of them is bitwise equal to the first."""
    args, kw = shape_inputs(T, S, 256, 1, S == 520, fmt, torch.bfloat16)
    args = [a.to(cuda_device) for a in args]
    B, _, H, _ = args[0].shape
    assert daq._geometry(B, T, H, 1, S, 256, kw["bits"], True,
                         daq.tensor_cores_fit(args[0], args[1], args[3]),
                         args[0].device.index).splits > 1
    outs = [ops.decode_attention_quant(*args, kw["window"], ring=kw["ring"],
                                       bits=kw["bits"]) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("path,row_tile,hd,warps,splits", [
    (0, 4, 256, 8, 16), (0, 8, 256, 8, 8), (1, 16, 256, 8, 16),
    (1, 16, 64, 8, 9)])
def test_decode_attention_clusters_fit_the_card(cuda_device, path, row_tile,
                                                hd, warps, splits):
    """The clusters the chooser asks for can be scheduled on this card,
    within its shared memory."""
    geo = daq.Geometry(path, row_tile, 1, warps, splits)
    for bits in (4, 8):
        info = daq.instance_info(geo, bits, True, hd)
        assert info["clusters"] >= 1
        assert 0 < info["smem_bytes"] <= 227 * 1024


def mt_args(M, V, D, bits, block, seed, dtype, device):
    rng = np.random.default_rng(seed)
    n_codes = 16 if bits == 4 else 256
    codes = torch.from_numpy(rng.integers(0, n_codes, (V, D)).astype(
        np.uint8))
    if bits == 4:
        codes = pack_nibbles(codes)     # interleaved along V
    scales = (torch.from_numpy(np.abs(rng.standard_normal(
        (V, D // block))).astype(np.float32)) * 0.05 + 0.01)
    cb = torch.from_numpy(np.sort(rng.standard_normal(n_codes)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32))
    return (x.to(dtype).to(device), codes.to(device),
            scales.to(torch.bfloat16).to(device), cb.to(device))


def check_mt(args, block, bits, dtype):
    """One counted launch, held to the plain version: f32 x at 1e-5
    relative (summation order), bf16 x at the tensor-core tolerance (cb and
    cb*scale rounded to bf16, the output rounded to bf16); a second call is
    bitwise equal (no K split)."""
    before = dqmt.launches
    y = ops.dequant_matmul_t(*args, block=block, bits=bits)
    torch.cuda.synchronize()
    assert dqmt.launches == before + 1
    want = dequant_matmul_t_ref(*args, block, bits).float().cpu().numpy()
    assert y.dtype == dtype and y.shape == want.shape
    scale = float(np.abs(want).max())
    tol = (dict(rtol=1e-5, atol=1e-5 * scale) if dtype == torch.float32
           else dict(rtol=1.6e-2, atol=1e-2 * scale))
    np.testing.assert_allclose(y.float().cpu().numpy(), want, **tol)
    assert torch.equal(y, ops.dequant_matmul_t(*args, block=block,
                                               bits=bits))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 5, 32, 40])
@pytest.mark.parametrize("bits,block", [(4, 32), (4, 64), (4, 128),
                                        (8, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_t_kernel(cuda_device, M, bits, block, dtype):
    args = mt_args(M, 1024, 1152, bits, block, M + bits + block, dtype,
                   cuda_device)
    check_mt(args, block, bits, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M,V,D,bits,block", [
    (4, 1040, 1152, 4, 64), (32, 1040, 1152, 4, 128),   # one nibble tile
    (5, 1040, 1152, 8, 32),                              # ragged warp tile
    (3, 1040, 96, 4, 32), (17, 1024, 96, 8, 32),         # D % 64 != 0
    (4, 1040, 160, 4, 20), (9, 512, 160, 8, 20),         # block % 16 != 0
    (2, 256, 16384, 4, 64),          # bf16 x too long for the tensor cores
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_matmul_t_kernel_edges(cuda_device, M, V, D, bits, block,
                                       dtype):
    args = mt_args(M, V, D, bits, block, M + V + D, dtype, cuda_device)
    check_mt(args, block, bits, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_dequant_matmul_t_codes_aligned_to_4_bytes(cuda_device, offset,
                                                   bits):
    """Codes 4- or 8-byte but not 16-byte aligned (a view into a larger
    buffer) take narrower code loads, with the aligned codes' result."""
    x, codes, scales, cb = mt_args(4, 1040, 1152, bits, 64, offset + bits,
                                   torch.bfloat16, cuda_device)
    buf = torch.empty(codes.numel() + 32, dtype=torch.uint8,
                      device=cuda_device)
    base = -buf.data_ptr() % 16 + offset
    shifted = buf[base:base + codes.numel()].view(codes.shape)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 16 == offset
    assert dqmt.code_vec(shifted.data_ptr(), 1152) == offset
    assert dqmt.code_vec(codes.data_ptr(), 1152) == 16
    check_mt((x, shifted, scales, cb), 64, bits, torch.bfloat16)
    y = ops.dequant_matmul_t(x, shifted, scales, cb, block=64, bits=bits)
    assert torch.equal(y, ops.dequant_matmul_t(x, codes, scales, cb,
                                               block=64, bits=bits))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("bits,block", [(4, 64), (8, 64), (4, 20)])
def test_dequant_matmul_t_two_blocks_per_sm(cuda_device, M, bits, block):
    """The tensor-core instances keep two blocks of 8 warps on an SM (so
    at most 128 registers a thread), as their launch bounds ask."""
    assert dqmt.tc_blocks_per_sm(bits, M, 1152 if block == 64 else 160,
                                 block) >= 2


@pytest.mark.cuda
def test_dequant_matmul_t_inference_mode_codebook(cuda_device):
    """A codebook made under torch.inference_mode (no version counter)
    gives the plain version's result, also after an in-place write."""
    x, codes, scales, cb = mt_args(4, 1024, 1152, 4, 64, 3, torch.bfloat16,
                                   cuda_device)
    with torch.inference_mode():
        cbi = cb.clone()
        check_mt((x, codes, scales, cbi), 64, 4, torch.bfloat16)
        cbi.mul_(2.0)
        check_mt((x, codes, scales, cbi), 64, 4, torch.bfloat16)


@pytest.mark.cuda
def test_kernels_raise_on_bad_operands(cuda_device):
    cb = kv_codebook("q8").to(cuda_device)
    with pytest.raises(ValueError, match="tile by block"):
        ops.block_quant(torch.zeros(4, 30, device=cuda_device), cb, block=32)
    args, kw = attn_inputs("linear", "q8", torch.float32)
    args = [a.to(cuda_device) for a in args]
    with pytest.raises(ValueError, match="q_positions"):
        ops.decode_attention_quant(*args[:-1], args[-1].long(), 0, bits=8)
    x, codes, scales, cb4 = mt_args(2, 256, 64, 4, 32, 0, torch.float32,
                                    cuda_device)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant_matmul_t(x, codes, scales[:, :1].contiguous(), cb4,
                             block=32, bits=4)


# ---------------------------------------------------------------------------
# Teacher-forcing M: apply flattens (B, T) into the rows of every matmul


PREFILL_M = [33, 512, 2048]
GEMMA3_PROJECTIONS = [(1152, 1024), (1152, 256), (1024, 1152), (1152, 6912),
                      (6912, 1152)]
GEMMA3_TABLE = (262144, 1152)


def prefill_args(M, K, N, bits, block, seed, device, x_cols=None):
    """bf16 x (M, K) (or (M, x_cols)), codes (K, N) nibble-packed along K
    at 4 bits, bf16 scales (K, N // block) and a sorted codebook, made on
    the card from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_codes = 16 if bits == 4 else 256
    x = torch.randn(M, x_cols or K, generator=gen, device=device).to(
        torch.bfloat16)
    codes = torch.randint(0, n_codes, (K, N), generator=gen, device=device,
                          dtype=torch.int32).to(torch.uint8)
    if bits == 4:
        codes = pack_nibbles(codes).contiguous()
    scales = (torch.rand(K, N // block, generator=gen, device=device) * 0.05
              + 0.01).to(torch.bfloat16)
    cb = torch.sort(torch.randn(n_codes, generator=gen, device=device)).values
    return x, codes, scales, cb


def hold_on_card(y, y_plain):
    """The bf16 tensor-core tolerance (cb·scale and the output rounded to
    bf16), compared on the card: the unembed's output at M = 2048 is 1 GB."""
    scale = float(y_plain.float().abs().max())
    torch.testing.assert_close(y.float(), y_plain.float(), rtol=1.6e-2,
                               atol=1e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("M", PREFILL_M)
@pytest.mark.parametrize("K,N", GEMMA3_PROJECTIONS)
def test_dequant_matmul_at_teacher_forcing_m(cuda_device, M, K, N):
    """gemma3-1b's projections at M past one 32-row tile: one launch a call,
    reruns bitwise equal, no K split at M = 2048."""
    args = prefill_args(M, K, N, 4, 64, M + K + N, cuda_device)
    before = dqm.launches
    y = ops.dequant_matmul(*args, block=64, bits=4)
    again = ops.dequant_matmul(*args, block=64, bits=4)
    torch.cuda.synchronize()
    assert dqm.launches == before + 2
    assert torch.equal(y, again)
    if M == 2048:
        _, geo, _, _ = dqm._geometry(True, 1, M, K, N, 4, 8,
                                     cuda_device.index or 0)
        assert geo.splits == 1 and geo.m_tiles == 64
    hold_on_card(y, dequant_matmul_ref(*args, 64, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("M", PREFILL_M)
def test_dequant_matmul_8bit_at_teacher_forcing_m(cuda_device, M):
    args = prefill_args(M, 1152, 1024, 8, 64, M, cuda_device)
    y = ops.dequant_matmul(*args, block=64, bits=8)
    assert torch.equal(y, ops.dequant_matmul(*args, block=64, bits=8))
    hold_on_card(y, dequant_matmul_ref(*args, 64, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("M", PREFILL_M)
def test_dequant_matmul_t_at_teacher_forcing_m(cuda_device, M):
    """gemma3-1b's tied 262144 x 1152 table (nibble-packed along V) at the
    teacher-forcing M: one launch a call, reruns bitwise equal."""
    V, D = GEMMA3_TABLE
    args = prefill_args(M, V, D, 4, 64, M, cuda_device, x_cols=D)
    before = dqmt.launches
    y = ops.dequant_matmul_t(*args, block=64, bits=4)
    again = ops.dequant_matmul_t(*args, block=64, bits=4)
    torch.cuda.synchronize()
    assert dqmt.launches == before + 2
    assert y.shape == (M, V) and torch.equal(y, again)
    hold_on_card(y, dequant_matmul_t_ref(*args, 64, 4))


# ---------------------------------------------------------------------------
# Data-fitted codebooks: Lloyd-Max plans give every tensor its own
# asymmetric, unevenly spaced codebook (16 points nibble-packed, more than
# 16 at one byte a code), and one serve then uses many codebooks


def lloyd_codebook(n_points, seed, device):
    """A Lloyd-Max codebook of ``n_points`` fitted to skewed heavy-tailed
    data scaled into [-1, 1]: asymmetric and unevenly spaced."""
    from repro_torch.core.lloyd import lloyd_max
    rng = np.random.default_rng(seed)
    x = rng.standard_t(4, 100_000) + 0.3 * rng.gamma(2.0, 1.0, 100_000)
    x = x / np.abs(x).max()
    cb = lloyd_max(x, float(np.log2(n_points)), init="uniform", seed=seed)
    assert cb.n == n_points
    cps = np.asarray(cb.codepoints)
    assert not np.allclose(cps, -cps[::-1])            # asymmetric
    assert np.ptp(np.diff(cps)) > 0.1 * np.diff(cps).mean()   # uneven
    return cb.torch_codepoints(device)


def lloyd_matmul_args(M, K, N, n_points, seed, device, transposed=False):
    """bf16 x, codes drawn over the codebook (nibble-packed along the
    contraction when it has at most 16 points), bf16 block-64 scales."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = 4 if n_points <= 16 else 8
    rows, cols = (N, K) if transposed else (K, N)
    x = torch.randn(M, K, generator=gen, device=device).to(torch.bfloat16)
    codes = torch.randint(0, n_points, (rows, cols), generator=gen,
                          device=device, dtype=torch.int32).to(torch.uint8)
    if bits == 4:
        codes = pack_nibbles(codes).contiguous()
    scales = (torch.rand(rows, cols // 64, generator=gen, device=device)
              * 0.05 + 0.01).to(torch.bfloat16)
    return (x, codes, scales, lloyd_codebook(n_points, seed, device)), bits


@pytest.mark.cuda
@pytest.mark.parametrize("n_points", [16, 23])
@pytest.mark.parametrize("M", [1, 4, 32, 2048])
@pytest.mark.parametrize("K,N", GEMMA3_PROJECTIONS)
def test_dequant_matmul_lloyd_codebooks(cuda_device, n_points, M, K, N):
    args, bits = lloyd_matmul_args(M, K, N, n_points, M + K + N, cuda_device)
    y = ops.dequant_matmul(*args, block=64, bits=bits)
    assert torch.equal(y, ops.dequant_matmul(*args, block=64, bits=bits))
    hold_on_card(y, dequant_matmul_ref(*args, 64, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("n_points", [16, 23])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_dequant_matmul_t_lloyd_codebooks(cuda_device, n_points, M):
    """gemma3-1b's tied 262144 x 1152 table with a data-fitted codebook."""
    V, D = GEMMA3_TABLE
    args, bits = lloyd_matmul_args(M, D, V, n_points, M, cuda_device,
                                   transposed=True)
    y = ops.dequant_matmul_t(*args, block=64, bits=bits)
    assert y.shape == (M, V)
    hold_on_card(y, dequant_matmul_t_ref(*args, 64, bits))


@pytest.mark.cuda
def test_table_cache_holds_many_codebooks(cuda_device):
    """Twelve codebooks in turn, twice round (a Lloyd plan's tensors in one
    serve): each call uses its own codebook's table, one cached entry per
    codebook, equal to a fresh build; the entries go with their
    codebooks."""
    x, codes, scales, _ = lloyd_matmul_args(4, 1152, 1024, 16, 0,
                                            cuda_device)[0]
    before = len(dqm._tables)
    cbs = [lloyd_codebook(16, 100 + i, cuda_device) for i in range(12)]
    wants = [dequant_matmul_ref(x, codes, scales, cb, 64, 4) for cb in cbs]
    for _ in range(2):
        for cb, want in zip(cbs, wants):
            hold_on_card(ops.dequant_matmul(x, codes, scales, cb, block=64,
                                            bits=4), want)
            xt = x[:, :1024].contiguous()     # codes read as (V, D)
            hold_on_card(ops.dequant_matmul_t(xt, codes, scales, cb,
                                              block=64, bits=4),
                         dequant_matmul_t_ref(xt, codes, scales, cb, 64, 4))
    assert len(dqm._tables) == before + 12
    for cb in cbs:
        _, version, bits, table = dqm._tables[id(cb)]
        assert bits == 4 and version == cb._version
        assert torch.equal(table, dqm.dequant_table(cb, 4))
    outs = [ops.dequant_matmul(x, codes, scales, cb, block=64, bits=4)
            for cb in cbs]
    assert all(not torch.equal(outs[0], o) for o in outs[1:])
    del cbs, outs, cb
    import gc
    gc.collect()
    assert len(dqm._tables) == before
