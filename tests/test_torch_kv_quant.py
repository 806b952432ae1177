"""The port's quantised-KV and tied-unembed kernels against the JAX package:
``kv_codebook``, ``block_quant``/``quantise_kv`` (bitwise), the quantised
cache write, ``decode_attention_quant`` and ``dequant_matmul_t`` — their
plain torch versions (what the CPU runs) against the reference's jnp
oracles and its Pallas bodies in interpret mode. The CUDA kernels are held
against these plain versions on the card in ``test_torch_cuda_kernels.py``.

The same seeded numpy inputs go to both packages."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.nibble import pack_nibbles as jpack
from repro.kernels import ops as jops
from repro.kernels.block_quant.ref import block_dequant_ref as jbd_ref
from repro.kernels.block_quant.ref import block_quant_ref as jbq_ref
from repro.kernels.decode_attention.ref import \
    decode_attention_quant_ref as jdaq_ref
from repro.kernels.dequant_matmul.ref import \
    dequant_matmul_t_ref as jdqmt_ref
from repro.models import layers as jl
from repro.serve import cache as jcache

from repro_torch.core.nibble import pack_nibbles
from repro_torch.kernels import build, ops
from repro_torch.kernels.block_quant import block_quant as bq
from repro_torch.kernels.block_quant.ref import (block_dequant_ref,
                                                 block_quant_ref, midpoints,
                                                 pack_pairs)
from repro_torch.kernels.decode_attention import decode_attention as daq
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_quant_ref, dequant_kv_ref, unpack_nibbles_hd)
from repro_torch.kernels.dequant_matmul import dequant_matmul_t as dqmt
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_t_ref
from repro_torch.models import layers as tl
from repro_torch.serve import cache as tcache

FMTS = ["q8", "q4"]


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def bits_of(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# Codebook


@pytest.mark.parametrize("fmt", FMTS)
def test_kv_codebook_is_jnp_linspace_bit_for_bit(fmt):
    want = np.asarray(jnp.linspace(-1.0, 1.0, 2 ** jcache.kv_bits(fmt),
                                   dtype=jnp.float32))
    got = tcache.kv_codebook(fmt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(bits_of(got), bits_of(want))
    np.testing.assert_array_equal(
        bits_of(got), bits_of(np.asarray(jcache.kv_codebook(fmt))))
    # and so are the midpoints the quantiser compares against
    cb = jcache.kv_codebook(fmt)
    np.testing.assert_array_equal(
        bits_of(midpoints(tcache.kv_codebook(fmt)).numpy()),
        bits_of(np.asarray((cb[1:] + cb[:-1]) * 0.5)))


def test_kv_codebook_refuses_dense():
    with pytest.raises(ValueError, match="no codebook"):
        tcache.kv_codebook("f32")


# ---------------------------------------------------------------------------
# block_quant


def hard_rows(rows, hd, cb, seed):
    """Rows that probe every edge of the quantiser: random rows; an all-zero
    row; rows whose absmax rounds *down* in bf16 (so the scale is bumped
    one ulp); rows with values exactly on codebook midpoints (absmax 2.0, a
    bf16-exact scale, so x / scale == midpoint exactly); a row of one
    sign."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, hd)).astype(np.float32)
    mids = np.asarray(midpoints(torch.from_numpy(cb)))
    x[1] = 0.0
    x[2, 0] = np.float32(1.0 + 2.0 ** -10)          # rounds down to 1.0
    x[2, 1:] = np.clip(x[2, 1:], -1, 1)
    x[3] = np.clip(x[3], -0.5, 0.5)
    x[3, 0] = np.float32(-(3.0 + 2.0 ** -7))        # 3 + 1/128: rounds down
    pick = rng.integers(0, len(mids), hd)
    x[4] = (mids[pick] * np.float32(2.0)).astype(np.float32)
    x[4, 0] = np.float32(2.0)                       # absmax 2.0 exactly
    x[5] = np.abs(x[5])
    return x


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("hd", [32, 64, 256])
def test_block_quant_bitwise_vs_reference(fmt, hd):
    cb = tcache.kv_codebook(fmt).numpy()
    x = hard_rows(24, hd, cb, seed=hd + len(fmt))
    codes, scales = ops.block_quant(t(x), t(cb), block=hd)
    want_c, want_s = jbq_ref(jnp.asarray(x), jnp.asarray(cb), hd)
    kern_c, kern_s = jops.block_quant_interpret(jnp.asarray(x),
                                                jnp.asarray(cb), hd)
    assert codes.dtype == torch.uint8 and scales.dtype == torch.float32
    for c, s in ((want_c, want_s), (kern_c, kern_s)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(c))
        np.testing.assert_array_equal(bits_of(scales.numpy()), bits_of(s))
    # the probes did probe: a zero scale, a bumped scale, midpoint hits
    s = scales.numpy()[:, 0]
    assert s[1] == 0 and codes.numpy()[1].tolist() == [
        int(np.searchsorted(midpoints(t(cb)).numpy(), 0.0))] * hd
    assert s[2] > 1.0 and s[3] > 3.0 and s[4] == 2.0


@pytest.mark.parametrize("block", [32, 64])
def test_block_quant_many_blocks_per_row(block):
    cb = tcache.kv_codebook("q8").numpy()
    x = hard_rows(8, 256, cb, seed=block)
    codes, scales = ops.block_quant(t(x), t(cb), block=block)
    want_c, want_s = jbq_ref(jnp.asarray(x), jnp.asarray(cb), block)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(bits_of(scales.numpy()), bits_of(want_s))


def test_block_quant_packed_scatter_equals_pack_then_index():
    """The fused form the cache write uses (pack pairs, scatter rows into a
    buffer) writes the bytes of quantise -> pack -> index assignment."""
    cb = tcache.kv_codebook("q4")
    x = t(hard_rows(6, 32, cb.numpy(), seed=3))
    codes_buf = torch.zeros(10, 16, dtype=torch.uint8)
    scales_buf = torch.zeros(10, 1)
    rows = torch.tensor([7, 0, 3, 9, 1, 4])
    ops.block_quant(x, cb, block=32, pack=True, out=(codes_buf, scales_buf),
                    rows=rows)
    c, s = block_quant_ref(x, cb, 32)
    assert torch.equal(codes_buf[rows], pack_pairs(c))
    assert torch.equal(scales_buf[rows], s)
    untouched = [r for r in range(10) if r not in rows.tolist()]
    assert not codes_buf[untouched].any() and not scales_buf[untouched].any()


@pytest.mark.parametrize("fmt", FMTS)
def test_quantise_kv_bytes_bitwise(fmt):
    rng = np.random.default_rng(11)
    new = rng.standard_normal((3, 5, 2, 32)).astype(np.float32)
    new[0, 1] = 0.0
    bits = jcache.kv_bits(fmt)
    want_c, want_s = jl.quantise_kv(jnp.asarray(new), jcache.kv_codebook(fmt),
                                    bits)
    got_c, got_s = tl.quantise_kv(t(new), tcache.kv_codebook(fmt), bits)
    assert tuple(got_c.shape) == (3, 5, 2, 32 if bits == 8 else 16)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(bits_of(got_s.numpy()), bits_of(want_s))
    # bf16 rows quantise as their exact f32 values, as the reference casts
    nb = torch.from_numpy(new).to(torch.bfloat16)
    jb = jnp.asarray(nb.float().numpy())
    wc, _ = jl.quantise_kv(jb.astype(jnp.bfloat16), jcache.kv_codebook(fmt),
                           bits)
    np.testing.assert_array_equal(
        tl.quantise_kv(nb, tcache.kv_codebook(fmt), bits)[0].numpy(),
        np.asarray(wc))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("ring", [False, True])
def test_quantised_cache_write_bitwise(fmt, ring):
    """update_kv_cache on a QuantisedKV, in place, against the reference's
    functional write (ring: positions wrap the 12-slot ring)."""
    B, T, S, K, hd = 2, 4, 12, 2, 32
    rng = np.random.default_rng(5)
    bits = jcache.kv_bits(fmt)
    hdc = hd // 2 if bits == 4 else hd
    codes = rng.integers(0, 256, (B, S, K, hdc)).astype(np.uint8)
    scales = rng.random((B, S, K, 1)).astype(np.float32)
    new = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    pos = np.array([3, 10 if ring else 8], np.int32)
    want = jl.update_kv_cache(
        jl.QuantisedKV(jnp.asarray(codes), jnp.asarray(scales)),
        jnp.asarray(new), jnp.asarray(pos), ring=ring,
        codebook=jcache.kv_codebook(fmt))
    got = tl.QuantisedKV(t(codes), t(scales))
    out = tl.update_kv_cache(got, t(new), t(pos), ring=ring,
                             codebook=tcache.kv_codebook(fmt))
    assert out.codes is got.codes
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(bits_of(got.scales.numpy()),
                                  bits_of(want.scales))


def kv_pair(fmt, n, hd, seed):
    """k and v rows (n, hd) with the quantiser's edges (midpoint ties, a
    zero row, absmaxes that round down in bf16), as numpy f32."""
    cb = tcache.kv_codebook(fmt).numpy()
    return (hard_rows(n, hd, cb, seed), hard_rows(n, hd, cb, seed + 1)[::-1]
            .copy())


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_quant_kv_plain_equals_two_block_quant_calls(fmt, dtype):
    """The paired entry's plain path writes the bytes of two single
    ``block_quant`` writes at the same rows, and nothing else."""
    k, v = (t(a).to(dtype) for a in kv_pair(fmt, 12, 64, seed=21))
    cb = tcache.kv_codebook(fmt)
    pack = fmt == "q4"
    width = 32 if pack else 64
    rows = torch.tensor([5, 17, 0, 9, 30, 2, 11, 8, 23, 1, 14, 27])

    def caches():
        return [(torch.zeros(31, 1, width, dtype=torch.uint8),
                 torch.zeros(31, 1, 1)) for _ in range(2)]
    got, want = caches(), caches()
    out = ops.block_quant_kv(k, v, cb, block=64, pack=pack, out_k=got[0],
                             out_v=got[1], rows=rows)
    assert out[0] is got[0] and out[1] is got[1]
    for x, buf in zip((k, v), want):
        ops.block_quant(x, cb, block=64, pack=pack, out=buf, rows=rows)
    for (gc, gs), (wc, ws) in zip(got, want):
        assert torch.equal(gc, wc) and torch.equal(gs, ws)
    untouched = [r for r in range(31) if r not in rows.tolist()]
    assert not got[0][0][untouched].any() and not got[1][1][untouched].any()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("ring", [False, True])
def test_write_kv_pair_bitwise_vs_reference(fmt, hd, ring):
    """``write_kv_pair`` (one ``block_quant_kv`` call) on a quantised k/v
    pair against the reference's ``quantise_kv`` + cache update (its jnp
    ``block_quant_ref``), bit for bit: ring rows wrap the 12-slot ring, and
    the new rows hold midpoint ties, a zero row and round-down absmaxes."""
    B, T, S, K = 2, 4, 12, 2
    rng = np.random.default_rng(hd + 2 * ring)
    bits = jcache.kv_bits(fmt)
    hdc = hd // 2 if bits == 4 else hd
    pos = np.array([3, 10 if ring else 8], np.int32)
    news = [a.reshape(B, T, K, hd) for a in kv_pair(fmt, B * T * K, hd,
                                                      seed=hd)]
    caches, want = [], []
    for new in news:
        codes = rng.integers(0, 256, (B, S, K, hdc)).astype(np.uint8)
        scales = rng.random((B, S, K, 1)).astype(np.float32)
        want.append(jl.update_kv_cache(
            jl.QuantisedKV(jnp.asarray(codes), jnp.asarray(scales)),
            jnp.asarray(new), jnp.asarray(pos), ring=ring,
            codebook=jcache.kv_codebook(fmt)))
        caches.append(tl.QuantisedKV(t(codes), t(scales)))
    rows, slots = tl.cache_slots(t(pos), T, S, ring=ring)
    out = tl.write_kv_pair(*caches, *map(t, news), rows, slots,
                           tcache.kv_codebook(fmt))
    assert out[0] is caches[0] and out[1] is caches[1]
    for got, w in zip(caches, want):
        np.testing.assert_array_equal(got.codes.numpy(), np.asarray(w.codes))
        np.testing.assert_array_equal(bits_of(got.scales.numpy()),
                                      bits_of(w.scales))


def test_nibble_hd_unpack_inverts_pack_pairs():
    codes = torch.arange(32, dtype=torch.uint8).reshape(2, 16) % 16
    assert torch.equal(unpack_nibbles_hd(pack_pairs(codes)), codes)


# ---------------------------------------------------------------------------
# decode_attention_quant


def quant_cache(rng, B, S, K, hd, fmt):
    """A dense random cache quantised through the reference's write path,
    as numpy (codes, scales)."""
    dense = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    c, s = jl.quantise_kv(jnp.asarray(dense), jcache.kv_codebook(fmt),
                          jcache.kv_bits(fmt))
    return np.asarray(c), np.asarray(s)


ATTN_CASES = {
    # name: (S, T, window, ring, positions (B, T))
    "linear": (24, 1, 0, False, [[23], [17]]),
    "window": (24, 1, 7, False, [[20], [19]]),
    "ring_wrapped": (24, 1, 8, True, [[27], [40]]),
    "ragged_chunk": (24, 4, 0, False, [[4, 5, 6, 7], [0, 1, 2, 3]]),
    "ring_chunk": (20, 4, 16, True, [[30, 31, 32, 33], [2, 3, 4, 5]]),
}


def attn_inputs(name, fmt, dtype):
    S, T, window, ring, positions = ATTN_CASES[name]
    B, K, H, hd = 2, 2, 4, 16
    rng = np.random.default_rng(list(ATTN_CASES).index(name) * 2
                                + FMTS.index(fmt))
    kc, ks = quant_cache(rng, B, S, K, hd, fmt)
    vc, vs = quant_cache(rng, B, S, K, hd, fmt)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    qp = np.asarray(positions, np.int32)
    jq = jnp.asarray(q, jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16)
    jargs = (jq, *map(jnp.asarray, (kc, ks, vc, vs)),
             jcache.kv_codebook(fmt), jnp.asarray(qp))
    targs = (t(q).to(dtype), t(kc), t(ks), t(vc), t(vs),
             tcache.kv_codebook(fmt), t(qp))
    return jargs, targs, dict(window=window, ring=ring,
                              bits=jcache.kv_bits(fmt)), S


def attn_tol(want, dtype):
    """f32: 1e-5 relative (summation order only). bf16: the oracle rounds
    the dequantised K to q's dtype before the scores and the scores to bf16
    (``layers.chunked_decode_attention``), and the port rounds at other
    places, so 2e-2 of max|out|."""
    scale = float(np.abs(want).max())
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5 * scale)
    return dict(rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_plain_vs_reference(fmt, name, dtype):
    jargs, targs, kw, _ = attn_inputs(name, fmt, dtype)
    got = ops.decode_attention_quant(*targs, kw["window"], ring=kw["ring"],
                                     bits=kw["bits"])
    want = np.asarray(jdaq_ref(*jargs, **kw), np.float32)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want,
                               **attn_tol(want, dtype))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_decode_attention_plain_vs_pallas_interpret(fmt, name):
    """The Pallas body's online softmax over 4-slot chunks against the
    port's plain version, in f32."""
    jargs, targs, kw, S = attn_inputs(name, fmt, torch.float32)
    got = ops.decode_attention_quant(*targs, kw["window"], ring=kw["ring"],
                                     bits=kw["bits"])
    want = np.asarray(jops.decode_attention_quant_interpret(
        *jargs, kw["window"], ring=kw["ring"], bits=kw["bits"], schunk=4),
        np.float32)
    np.testing.assert_allclose(got.numpy(), want,
                               **attn_tol(want, torch.float32))


@pytest.mark.parametrize("fmt", FMTS)
def test_dequant_kv_bitwise(fmt):
    rng = np.random.default_rng(2)
    c, s = quant_cache(rng, 2, 5, 2, 16, fmt)
    bits = jcache.kv_bits(fmt)
    want = jops.dequant_kv(jnp.asarray(c), jnp.asarray(s),
                           jcache.kv_codebook(fmt), bits)
    got = dequant_kv_ref(t(c), t(s), tcache.kv_codebook(fmt), bits)
    np.testing.assert_array_equal(bits_of(got.numpy()), bits_of(want))
    cache = tl.QuantisedKV(t(c), t(s))
    assert torch.equal(tl.dequant_kv(cache, tcache.kv_codebook(fmt)), got)
    assert tl.codebook_bits(tcache.kv_codebook(fmt)) == bits


@pytest.mark.parametrize("fmt", FMTS)
def test_block_dequant_bitwise(fmt):
    cb = tcache.kv_codebook(fmt).numpy()
    x = hard_rows(8, 64, cb, seed=4)
    codes, scales = block_quant_ref(t(x), t(cb), 32)
    want = jbd_ref(jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()),
                   jnp.asarray(cb), 32, dtype=jnp.float32)
    got = block_dequant_ref(codes, scales, t(cb), 32, dtype=torch.float32)
    np.testing.assert_array_equal(bits_of(got.numpy()), bits_of(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fmt", FMTS)
def test_ops_block_dequant_matches_the_reference(fmt, dtype):
    """``ops.block_dequant`` (the reference's public entry, its default
    bf16 output included) against ``repro.kernels.ops.block_dequant``."""
    cb = tcache.kv_codebook(fmt).numpy()
    x = hard_rows(8, 128, cb, seed=5)
    codes, scales = block_quant_ref(t(x), t(cb), 64)
    kw = {} if dtype == "bfloat16" else {"dtype": torch.float32}
    jkw = {} if dtype == "bfloat16" else {"dtype": jnp.float32}
    got = ops.block_dequant(codes, scales, t(cb), 64, **kw)
    want = jops.block_dequant(jnp.asarray(codes.numpy()),
                              jnp.asarray(scales.numpy()), jnp.asarray(cb),
                              64, **jkw)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# dequant_matmul_t


def mt_case(M, V, D, bits, block, seed):
    rng = np.random.default_rng(seed)
    n_codes = 16 if bits == 4 else 256
    x = rng.standard_normal((M, D)).astype(np.float32)
    codes = rng.integers(0, n_codes, (V, D)).astype(np.uint8)
    scales = (np.abs(rng.standard_normal((V, D // block))) * 0.05
              + 0.01).astype(np.float32)
    cb = np.sort(rng.standard_normal(n_codes)).astype(np.float32)
    return x, codes, scales, cb


def mt_torch(x, codes, scales, cb, bits, dtype=torch.float32, device="cpu"):
    c = t(codes)
    if bits == 4:
        c = pack_nibbles(c)      # interleaved along V, the embed layout
    return (t(x).to(dtype).to(device), c.to(device),
            t(scales).to(torch.bfloat16).to(device), t(cb).to(device))


def mt_jax(x, codes, scales, cb, bits):
    c = jnp.asarray(codes)
    if bits == 4:
        c = jpack(c)
    return (jnp.asarray(x), c, jnp.asarray(scales, jnp.bfloat16),
            jnp.asarray(cb))


MT_CASES = [(M, bits, block) for M in (1, 4, 32) for bits in (4, 8)
            for block in (32, 64, 128)]


@pytest.mark.parametrize("M,bits,block", MT_CASES)
def test_dequant_matmul_t_plain_vs_reference(M, bits, block):
    V, D = 512, 256
    case = mt_case(M, V, D, bits, block, seed=M * 10 + bits + block)
    got = ops.dequant_matmul_t(*mt_torch(*case, bits), block=block,
                               bits=bits)
    want = np.asarray(jdqmt_ref(*mt_jax(*case, bits), block=block,
                                bits=bits), np.float32)
    assert tuple(got.shape) == (M, V)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("M,bits,block", MT_CASES)
def test_dequant_matmul_t_plain_vs_pallas_interpret(M, bits, block):
    """The Pallas body writes bf16, so the bf16 tolerance holds."""
    V, D = 512, 256
    case = mt_case(M, V, D, bits, block, seed=M * 10 + bits + block + 1)
    got = ops.dequant_matmul_t(*mt_torch(*case, bits), block=block,
                               bits=bits)
    want = np.asarray(jops.dequant_matmul_t_interpret(
        *mt_jax(*case, bits), block=block, bits=bits), np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2,
                               atol=1e-2 * scale)


def test_dequant_matmul_t_nibble_and_byte_storage_agree():
    case = mt_case(3, 512, 128, 4, 64, seed=9)
    y4 = dequant_matmul_t_ref(*mt_torch(*case, 4), 64, 4)
    y8 = dequant_matmul_t_ref(*mt_torch(*case, 8), 64, 8)
    assert torch.equal(y4, y8)


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors take the plain versions; a CUDA call never does


def test_cpu_calls_count_no_launches():
    before = (bq.launches, daq.launches, dqmt.launches)
    cb = tcache.kv_codebook("q4")
    ops.block_quant(torch.randn(4, 32), cb, block=32)
    bufs = [(torch.zeros(4, 16, dtype=torch.uint8), torch.zeros(4, 1))
            for _ in range(2)]
    ops.block_quant_kv(torch.randn(4, 32), torch.randn(4, 32), cb, block=32,
                       pack=True, out_k=bufs[0], out_v=bufs[1],
                       rows=torch.arange(4))
    _, targs, kw, _ = attn_inputs("linear", "q8", torch.float32)
    ops.decode_attention_quant(*targs, kw["window"], ring=kw["ring"],
                               bits=kw["bits"])
    ops.dequant_matmul_t(*mt_torch(*mt_case(2, 512, 64, 4, 32, 1), 4),
                         block=32, bits=4)
    assert (bq.launches, daq.launches, dqmt.launches) == before


@pytest.mark.parametrize("which", ["block_quant", "block_quant_kv",
                                   "decode_attention", "dequant_matmul_t"])
def test_cuda_wrappers_raise_when_the_library_cannot_build(which,
                                                           monkeypatch):
    """No fallback: a wrapper whose library cannot build raises, counts
    nothing and returns no plain result in its place."""
    def fail(name):
        raise RuntimeError(f"{name}: nvcc not found")
    monkeypatch.setattr(build, "load_library", fail)
    before = (bq.launches, daq.launches, dqmt.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if which == "block_quant":
            bq.block_quant_cuda(torch.randn(4, 32), tcache.kv_codebook("q8"),
                                block=32)
        elif which == "block_quant_kv":
            call_kv(kv_wrapper_args())
        elif which == "decode_attention":
            _, targs, kw, _ = attn_inputs("linear", "q8", torch.float32)
            daq.decode_attention_quant_cuda(*targs, kw["window"],
                                            ring=kw["ring"], bits=kw["bits"])
        else:
            dqmt.dequant_matmul_t_cuda(
                *mt_torch(*mt_case(2, 512, 64, 4, 32, 1), 4), block=32,
                bits=4)
    assert (bq.launches, daq.launches, dqmt.launches) == before


def kv_wrapper_args(n=4, hd=32, fmt="q8", **bad):
    """Arguments of ``block_quant_kv_cuda`` (positional k, v, codebook,
    block; then the keywords), with any of them replaced by ``bad``."""
    pack = fmt == "q4"
    width = hd // 2 if pack else hd
    kw = dict(k=torch.randn(n, hd), v=torch.randn(n, hd),
              codebook=tcache.kv_codebook(fmt), block=hd, pack=pack,
              out_k=(torch.zeros(2 * n, width, dtype=torch.uint8),
                     torch.zeros(2 * n, 1)),
              out_v=(torch.zeros(2 * n, width, dtype=torch.uint8),
                     torch.zeros(2 * n, 1)),
              rows=torch.arange(n) * 2)
    kw.update(bad)
    args = [kw.pop(name) for name in ("k", "v", "codebook", "block")]
    return (*args, kw)


def call_kv(args):
    *pos, kw = args
    return bq.block_quant_kv_cuda(*pos, **kw)


def test_cuda_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "load_library", lambda name: object())
    with pytest.raises(ValueError, match="CUDA device"):
        bq.block_quant_cuda(torch.randn(4, 32), tcache.kv_codebook("q8"),
                            block=32)
    with pytest.raises(ValueError, match="CUDA device"):
        call_kv(kv_wrapper_args())
    _, targs, kw, _ = attn_inputs("linear", "q4", torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        daq.decode_attention_quant_cuda(*targs, 0, bits=4)
    with pytest.raises(ValueError, match="CUDA device"):
        dqmt.dequant_matmul_t_cuda(
            *mt_torch(*mt_case(2, 512, 64, 4, 32, 1), 4), block=32, bits=4)


@pytest.mark.parametrize("bad,match", [
    (dict(v=torch.randn(5, 32)), "must match k"),
    (dict(v=torch.randn(4, 32).to(torch.bfloat16)), "must match k"),
    (dict(rows=torch.arange(3)), "out needs rows"),
    (dict(rows=torch.arange(4, dtype=torch.int32)), "out needs rows"),
    (dict(out_v=(torch.zeros(8, 31, dtype=torch.uint8), torch.zeros(8, 1))),
     "do not hold rows"),
    (dict(out_k=(torch.zeros(8, 32, dtype=torch.uint8), torch.zeros(9, 1))),
     "do not hold rows"),
    (dict(block=24), "tile by block"),
])
def test_block_quant_kv_wrapper_checks_the_pair(monkeypatch, bad, match):
    """The paired wrapper refuses a v unlike k, rows that do not name one
    output row per input row, and outputs that do not hold whole rows,
    before it looks at the device."""
    monkeypatch.setattr(build, "load_library", lambda name: object())
    with pytest.raises(ValueError, match=match):
        call_kv(kv_wrapper_args(**bad))


def test_dequant_matmul_t_tiling_choices():
    # gemma3-1b's unembed: D = 1152 stages 32 rows of x (148 KB) in one
    # block per SM; decode (M = 4) fits 4 blocks per SM
    assert dqmt.m_tile(32, 1152) == 32 and dqmt.m_tile(4, 1152) == 4
    assert dqmt.m_tile(3, 1152) == 4 and dqmt.m_tile(64, 1152) == 32
    assert dqmt.m_tile(32, 4096) == 8          # 32 rows would not fit
    assert dqmt.n_blocks(131072, (256 + 32 * 1152) * 4, 132) == 132
    assert dqmt.n_blocks(131072, (256 + 4 * 1152) * 4, 132) == 528
    assert dqmt.n_blocks(20, 4096, 132) == 3


def test_dequant_matmul_t_tensor_core_choices():
    # gemma3-1b's unembed (D = 1152): the byte table (32 KB) and 8, 16 or 32
    # rows of x at a stride of 1156 bf16; two blocks fit an SM at M = 32
    assert dqmt.tc_smem(1, 1152) == 32768 + 8 * 1156 * 2
    assert 2 * dqmt.tc_smem(4, 1152) <= 228 * 1024
    assert [dqmt.tc_n_tiles(M, 1152) for M in (1, 4, 8, 9, 16, 17, 32, 64)] \
        == [1, 1, 1, 2, 2, 4, 4, 4]
    assert dqmt.tc_n_tiles(32, 4096) == 2      # 32 rows would not fit
    assert dqmt.tc_n_tiles(1, 16384) == 0      # the CUDA-core kernel's
    # 131072 byte rows: 1024 blocks' worth of tiles, one wave of 2 per SM
    assert dqmt.tc_blocks(131072, 132) == 264
    assert dqmt.tc_blocks(520, 132) == 5
    assert dqmt.code_vec(0, 1152) == 16 and dqmt.code_vec(8, 1152) == 8
    assert dqmt.code_vec(4, 1152) == 4 and dqmt.code_vec(0, 96) == 16
    assert dqmt.code_vec(0, 1160) == 8 and dqmt.code_vec(0, 1156) == 4


def test_decode_attention_split_choices():
    # gemma3-1b (B = 4, H = 4, K = 1): T = 1 is one 4-row tile, 8-slot
    # batches, 8 warps a block, S split into clusters of at most 16 blocks
    # (S = 1032: one warp takes a second batch)
    G = daq.Geometry
    assert daq.geometry(4, 1, 4, 1, 520, 132) == G(0, 4, 1, 8, 9)
    assert daq.geometry(4, 1, 4, 1, 1032, 132) == G(0, 4, 1, 8, 16)
    assert daq.geometry(4, 1, 4, 1, 1032, 132, max_cluster=8) == \
        G(0, 4, 1, 8, 8)
    # f32 q (no tensor cores): four 8-row tiles of 4-slot batches, splits
    # capped at one block per SM
    assert daq.geometry(4, 8, 4, 1, 520, 132) == G(0, 8, 4, 8, 8)
    assert daq.geometry(64, 1, 32, 8, 4096, 132) == G(0, 4, 1, 8, 1)
    assert daq.geometry(2, 1, 4, 2, 24, 132) == G(0, 4, 1, 3, 1)
    # bf16 prefill chunks on tensor cores: 16-row tiles, the 64-slot chunks
    # spread evenly over at most 16 splits (T = 8: two tiles a row)
    tc = dict(hd=256, tensor_cores=True)
    assert daq.geometry(4, 8, 4, 1, 520, 132, **tc) == G(1, 16, 2, 8, 9)
    assert daq.geometry(4, 8, 4, 1, 1032, 132, **tc) == G(1, 16, 2, 8, 9)
    assert daq.geometry(4, 9, 4, 1, 1032, 132, **tc) == G(1, 16, 3, 8, 9)
    assert daq.geometry(64, 8, 4, 1, 1032, 132, **tc) == G(1, 16, 2, 8, 1)
    # decode rows, or an hd without a tensor-core instance, stay on CUDA
    # cores
    assert daq.geometry(4, 1, 4, 1, 520, 132, **tc).path == 0
    assert daq.geometry(4, 8, 4, 1, 520, 132, hd=96,
                        tensor_cores=True).path == 0
