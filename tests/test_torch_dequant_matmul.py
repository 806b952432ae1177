"""The port's dequant_matmul: its plain torch version against the JAX
reference (the jnp oracle and the Pallas body in interpret mode) on the CPU,
and the CUDA kernel against the plain version on the card.

The reference modules are imported inside the tests (``pytest.importorskip``)
so that the card-only tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.nibble import (nibble_k_tile, pack_nibbles,
                                     unpack_nibbles)
from repro_torch.kernels import ops
from repro_torch.kernels import build
from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
from repro_torch.kernels.dequant_matmul import dequant_matmul_t as dqmt
from repro_torch.kernels.dequant_matmul.ref import (dequant_matmul_ref,
                                                    dequant_matmul_t_ref)


def make_case(M, K, N, bits, block, seed, lead=None):
    """Random operands as numpy: x f32, unpacked codes, f32 scales (to be
    cast to bf16 by each side the same way), an f32 codebook."""
    rng = np.random.default_rng(seed)
    n_codes = 16 if bits == 4 else 256
    pre = () if lead is None else (lead,)
    x = rng.standard_normal(pre + (M, K)).astype(np.float32)
    codes = rng.integers(0, n_codes, pre + (K, N)).astype(np.uint8)
    scales = (np.abs(rng.standard_normal(pre + (K, N // block))) * 0.05
              + 0.01).astype(np.float32)
    cb = np.sort(rng.standard_normal(n_codes)).astype(np.float32)
    return x, codes, scales, cb


def torch_operands(x, codes, scales, cb, bits, x_dtype, device="cpu"):
    c = torch.from_numpy(codes)
    if bits == 4:
        c = pack_nibbles(c)
    return (torch.from_numpy(x).to(x_dtype).to(device), c.to(device),
            torch.from_numpy(scales).to(torch.bfloat16).to(device),
            torch.from_numpy(cb).to(device))


def tol(y_ref, dtype):
    """f32: rtol 1e-5 / atol 1e-5 max|y| (summation order only); bf16:
    1e-2 relative (one bf16 rounding of the output plus the order)."""
    scale = float(np.abs(y_ref).max())
    if dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5 * scale)
    return dict(rtol=1e-2, atol=1e-2 * scale)


def jax_ref():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels.dequant_matmul.ref import dequant_matmul_ref as jref
    return jops, jref


def jax_operands(x, codes, scales, cb, bits, x_dtype):
    import jax.numpy as jnp
    from repro.core.nibble import pack_nibbles as jpack
    c = jnp.asarray(codes)
    if bits == 4:
        c = jpack(c)
    jdt = jnp.float32 if x_dtype == torch.float32 else jnp.bfloat16
    return (jnp.asarray(x, jdt), c, jnp.asarray(scales, jnp.bfloat16),
            jnp.asarray(cb))


CASES = [(M, K, bits, block) for M in (1, 3, 8, 32) for K in (64, 256, 704)
         for bits in (4, 8) for block in (64, 128)]


class TestPlainVsReference:
    @pytest.mark.parametrize("M,K,bits,block", CASES)
    @pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
    def test_matches_jnp_oracle(self, M, K, bits, block, x_dtype):
        _, jref = jax_ref()
        N = 256
        ops_np = make_case(M, K, N, bits, block, seed=M * 1000 + K + bits)
        y = ops.dequant_matmul(*torch_operands(*ops_np, bits, x_dtype),
                               block=block, bits=bits)
        y_ref = np.asarray(jref(*jax_operands(*ops_np, bits, x_dtype),
                                block=block, bits=bits), np.float32)
        assert y.dtype == x_dtype and y.shape == (M, N)
        np.testing.assert_allclose(y.float().numpy(), y_ref,
                                   **tol(y_ref, x_dtype))

    @pytest.mark.parametrize("M,K,bits,block", [
        (1, 64, 4, 64), (3, 256, 4, 128), (8, 704, 4, 64),
        (32, 256, 8, 128), (3, 704, 8, 64), (8, 64, 8, 64)])
    @pytest.mark.parametrize("variant", ["lut", "decode"])
    def test_matches_pallas_interpret(self, M, K, bits, block, variant):
        """The Pallas body writes bf16 (its default out_dtype) and the LUT
        strategy feeds bf16 x and W to the dot, so it is held at the bf16
        tolerance whatever x's dtype."""
        jops, _ = jax_ref()
        N = 256
        ops_np = make_case(M, K, N, bits, block, seed=7 + M + K)
        y = ops.dequant_matmul(*torch_operands(*ops_np, bits, torch.float32),
                               block=block, bits=bits)
        y_k = np.asarray(jops.dequant_matmul_interpret(
            *jax_operands(*ops_np, bits, torch.float32), block=block,
            bits=bits, variant=variant), np.float32)
        np.testing.assert_allclose(y.numpy(), y_k,
                                   **tol(y_k, torch.bfloat16))

    @pytest.mark.parametrize("bits", [4, 8])
    def test_lead_dim(self, bits):
        _, jref = jax_ref()
        ops_np = make_case(4, 256, 128, bits, 64, seed=31, lead=3)
        y = ops.dequant_matmul(*torch_operands(*ops_np, bits, torch.float32),
                               block=64, bits=bits)
        y_ref = np.asarray(jref(*jax_operands(*ops_np, bits, torch.float32),
                                block=64, bits=bits), np.float32)
        assert y.shape == (3, 4, 128)
        np.testing.assert_allclose(y.numpy(), y_ref,
                                   **tol(y_ref, torch.float32))

    def test_nibble_and_byte_storage_agree_bit_for_bit(self):
        x, codes, scales, cb = make_case(5, 512, 256, 4, 64, seed=3)
        y4 = dequant_matmul_ref(*torch_operands(x, codes, scales, cb, 4,
                                                torch.float32), 64, 4)
        y8 = dequant_matmul_ref(*torch_operands(x, codes, scales, cb, 8,
                                                torch.float32), 64, 8)
        assert torch.equal(y4, y8)


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        ops_np = make_case(3, 256, 128, 4, 64, seed=5)
        args = torch_operands(*ops_np, 4, torch.float32)
        before = dqm.launches
        y = ops.dequant_matmul(*args, block=64, bits=4)
        assert dqm.launches == before
        assert torch.equal(y, dequant_matmul_ref(*args, 64, 4))

    def test_cuda_branch_raises_when_the_kernel_cannot_build(self,
                                                             monkeypatch):
        """No fallback: a CUDA call whose library cannot load raises, and
        the plain result is never returned in its place."""
        def fail(name):
            raise RuntimeError(f"{name}: nvcc not found")
        monkeypatch.setattr(build, "load_library", fail)
        ops_np = make_case(3, 256, 128, 4, 64, seed=6)
        args = torch_operands(*ops_np, 4, torch.float32)
        before = dqm.launches
        with pytest.raises(RuntimeError, match="nvcc not found"):
            dqm.dequant_matmul_cuda(*args, block=64, bits=4)
        assert dqm.launches == before

    def test_build_raises_without_nvcc(self, monkeypatch):
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        monkeypatch.setattr(build, "CUDA_NVCC", build.Path("/nonexistent"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()

    def test_splits_fill_the_card_within_the_chunk_count(self):
        """bf16 (tensor cores): 16*vec columns a block, K split into one
        wave of blocks (two per SM), never more splits than 64-pair
        chunks."""
        geo = dqm.mma_geometry
        # paper-100m wk (K=768, N=256) at decode: 4 column tiles, 6 chunks
        g = geo(1, 4, 768, 256, 4, 132)
        assert (g.vec, g.m_tile, g.col_tiles, g.chunks, g.splits) == \
            (4, 8, 4, 6, 6)
        assert g.workspace_floats(1) == 6 * 4 * 8 * 64 and g.counters(1) == 4
        # deepseek-7b unembed: 800 column tiles already fill 132 SMs
        g = geo(1, 4, 4096, 102400, 4, 132)
        assert (g.vec, g.splits, g.workspace_floats(1), g.counters(1)) == \
            (8, 1, 0, 0)
        # deepseek-7b wq: 32 column tiles, 32 chunks, 8 splits (256 blocks)
        g = geo(1, 4, 4096, 4096, 4, 132)
        assert (g.vec, g.col_tiles, g.chunks, g.splits) == (8, 32, 32, 8)
        # gemma3-1b w_gate at prefill (M=32): 4-byte loads, 108 tiles x 2
        g = geo(1, 32, 1152, 6912, 4, 132)
        assert (g.vec, g.m_tile, g.col_tiles, g.splits) == (4, 32, 108, 2)
        # M=12: two n8-tiles; 8-bit codes pair two byte rows
        g = geo(1, 12, 4096, 4096, 8, 132)
        assert (g.vec, g.m_tile, g.chunks, g.splits) == (4, 16, 32, 4)
        # M > 32 takes M tiles; codes aligned to 4 bytes take 4-byte loads
        assert geo(1, 4, 4096, 4096, 4, 132, max_vec=4).vec == 4
        g = geo(2, 40, 2048, 384, 4, 132)
        assert (g.vec, g.m_tile, g.m_tiles, g.col_tiles, g.splits) == \
            (4, 32, 2, 6, 11)
        assert g.workspace_floats(2) == 11 * 2 * 12 * 32 * 64
        assert g.counters(2) == 24
        # f32 (CUDA cores): 128 columns a block
        assert dqm.choose_splits(1, 4, 768, 256, 4, 256, 4, 132) == 3
        assert dqm.choose_splits(1, 4, 4096, 102400, 4, 256, 4, 132) == 1
        assert dqm.choose_splits(1, 4, 4096, 4096, 4, 256, 4, 132) == 9


class TestDequantTable:
    """The tensor-core kernel's byte -> bf16x2 table, bitwise against
    unpacking the byte and casting the codebook to bf16."""

    @staticmethod
    def halves(table):
        w = table.to(torch.int64) & 0xFFFFFFFF
        return w & 0xFFFF, w >> 16

    @staticmethod
    def bf16_bits(v):
        return v.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF

    @pytest.mark.parametrize("n_codes", [16, 11])
    def test_nibble_table(self, n_codes):
        cb = torch.from_numpy(np.sort(
            np.random.default_rng(n_codes).standard_normal(n_codes))
            .astype(np.float32))
        table = dqm.dequant_table(cb, 4)
        assert table.dtype == torch.int32 and table.shape == (256,)
        # one byte row of 256 columns: every byte value once
        codes = unpack_nibbles(torch.arange(256, dtype=torch.uint8)[None],
                               2)
        cbp = torch.zeros(16)
        cbp[:n_codes] = cb
        lo, hi = self.halves(table)
        assert torch.equal(lo, self.bf16_bits(cbp[codes[0].long()]))
        assert torch.equal(hi, self.bf16_bits(cbp[codes[1].long()]))

    @pytest.mark.parametrize("n_codes", [256, 100])
    def test_byte_table(self, n_codes):
        cb = torch.from_numpy(np.random.default_rng(n_codes).standard_normal(
            n_codes).astype(np.float32))
        lo, hi = self.halves(dqm.dequant_table(cb, 8))
        want = torch.zeros(256, dtype=torch.int64)
        want[:n_codes] = self.bf16_bits(cb)
        assert torch.equal(lo, want) and not hi.any()

    def test_table_is_cached_per_codebook_and_rebuilt_on_write(self):
        cb = torch.linspace(-1, 1, 16)
        t1 = dqm._table(cb, 4)
        assert dqm._table(cb, 4) is t1
        cb[3] = 5.0
        t2 = dqm._table(cb, 4)
        assert t2 is not t1 and torch.equal(t2, dqm.dequant_table(cb, 4))
        assert not torch.equal(t1, t2)
        assert dqm._table(cb, 8) is not t2   # bits are part of the key

    def test_inference_tensor_codebook_gets_its_table(self):
        """A codebook made under ``torch.inference_mode`` has no version
        counter: its table is right, and right again after an in-place
        write, inside and outside inference mode."""
        with torch.inference_mode():
            cb = torch.linspace(-1, 1, 16)
            assert cb.is_inference()
            t1 = dqm._table(cb, 4)
            assert torch.equal(t1, dqm.dequant_table(cb, 4))
            cb[3] = 5.0
            t2 = dqm._table(cb, 4)
        assert torch.equal(t2, dqm.dequant_table(cb, 4))
        assert not torch.equal(t1, t2)
        assert torch.equal(dqm._table(cb, 4), t2)
        assert torch.equal(dqm._table(cb, 8), dqm.dequant_table(cb, 8))


# ---------------------------------------------------------------------------
# The tensor-core dequant_matmul_t's lane mapping, emulated on the CPU


def bf16_bits(f32):
    """f32 array -> bf16 bit patterns (uint32), rounded to nearest even."""
    u = np.ascontiguousarray(f32, np.float32).view(np.uint32)
    return (u + 0x7FFF + ((u >> 16) & 1)) >> 16


def bf16_value(bits):
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def prmt(x, y, sel):
    """CUDA __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes {y, x} (x the low word)."""
    both = x.astype(np.uint64) | (y.astype(np.uint64) << 32)
    out = np.zeros_like(x, dtype=np.uint32)
    for i in range(4):
        b = (both >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(0xFF)
        out |= b.astype(np.uint32) << np.uint32(8 * i)
    return out


def mul_bf16x2(a, s):
    """fma.rn.bf16x2 a * s + -0: each half's exact product rounded to bf16."""
    lo = bf16_bits(bf16_value(a & 0xFFFF) * bf16_value(s & 0xFFFF))
    hi = bf16_bits(bf16_value(a >> 16) * bf16_value(s >> 16))
    return (lo | (hi << 16)).astype(np.uint32)


def emulate_tc(x, codes, scales, table, M, V, D, block, bits, vec=16):
    """The csrc tc::kernel on the CPU, lane by lane: x (M, D) bf16 bits,
    codes the packed bytes, scales (V, D/block) bf16 bits, table the 256
    int32 words of ``dequant_table``; returns y (M, V) in f32 (the f32
    accumulator before the output rounding). Every warp tile of 16 byte
    rows at once, lanes (g, t) along two axes."""
    MT = 8 * dqmt.tc_n_tiles(M, D)
    NT = MT // 8
    byte_rows = V // 2 if bits == 4 else V
    tile = nibble_k_tile(V) if bits == 4 else V
    half = tile // 2
    n_sb = D // block
    n_tiles = -(-byte_rows // 16)
    n_chunks = -(-D // 64)
    tbl = table.numpy().view(np.uint32)
    g = np.arange(8)[None, :, None]
    t = np.arange(4)[None, None, :]
    wt = np.arange(n_tiles)[:, None, None]
    # the lane's byte rows j0 + g (i = 0) and j0 + 8 + g (i = 1)
    rows, ok, v = [], [], []
    for i in range(2):
        j = np.broadcast_to(wt * 16 + 8 * i + g, (n_tiles, 8, 4))
        okj = j < byte_rows
        r = np.where(okj, j, 0)
        rows.append(r)
        ok.append(okj)
        if bits == 4:
            lo = (r // half) * tile + r % half
            v += [lo, lo + half]
        else:
            v.append(r)
    # x staged with zeros past D; token rows past M are zeros
    y = np.zeros((M, V), np.float32)
    for m0 in range(0, M, MT):
        xs = np.zeros((MT, n_chunks * 64), np.uint32)
        mm = min(MT, M - m0)
        xs[:mm, :D] = x[m0:m0 + mm]
        n_mma = 2 if bits == 4 else 1
        acc = np.zeros((n_mma, n_tiles, 16, MT), np.float64)
        for c in range(n_chunks):
            d0 = c * 64 + 16 * t                     # (1, 1, 4)
            code = []
            for i in range(2):                       # 16 bytes a row
                byt = np.zeros((n_tiles, 8, 4, 16), np.uint32)
                for p in range(16 // vec):
                    dp = d0 + p * vec
                    okp = np.broadcast_to(dp < D, (n_tiles, 8, 4))
                    for q in range(vec):
                        col = np.minimum(dp + q, D - 1)
                        byt[..., p * vec + q] = np.where(
                            okp, codes[rows[i], np.broadcast_to(
                                col, rows[i].shape)], 0)
                code.append(byt)
            for s in range(4):
                sb = np.minimum((d0 + 4 * s) // block, n_sb - 1)
                sc = [np.broadcast_to(scales[vk, np.broadcast_to(sb, vk.shape)]
                                      * 0x10001, vk.shape).astype(np.uint32)
                      for vk in v]
                e = [[tbl[code[i][..., 4 * s + q]] for q in range(4)]
                     for i in range(2)]
                if bits == 4:
                    frags = [(mul_bf16x2(prmt(e[i][0], e[i][1], 0x5410),
                                         sc[2 * i]),
                              mul_bf16x2(prmt(e[i][0], e[i][1], 0x7632),
                                         sc[2 * i + 1]),
                              mul_bf16x2(prmt(e[i][2], e[i][3], 0x5410),
                                         sc[2 * i]),
                              mul_bf16x2(prmt(e[i][2], e[i][3], 0x7632),
                                         sc[2 * i + 1])) for i in range(2)]
                else:
                    frags = [(mul_bf16x2(prmt(e[0][0], e[0][1], 0x5410), sc[0]),
                              mul_bf16x2(prmt(e[1][0], e[1][1], 0x5410), sc[1]),
                              mul_bf16x2(prmt(e[0][2], e[0][3], 0x5410), sc[0]),
                              mul_bf16x2(prmt(e[1][2], e[1][3], 0x5410),
                                         sc[1]))]
                # B (16 k x 8 tokens) of each n-tile from the lane's 8-byte
                # load of x[token nt*8 + g][64c + 16t + 4s ...]
                B = np.zeros((16, MT), np.float64)
                for nt in range(NT):
                    for gg in range(8):
                        for tt in range(4):
                            base = c * 64 + 16 * tt + 4 * s
                            four = bf16_value(xs[nt * 8 + gg, base:base + 4])
                            m = nt * 8 + gg
                            B[2 * tt:2 * tt + 2, m] = four[:2]
                            B[2 * tt + 8:2 * tt + 10, m] = four[2:]
                for i, (a0, a1, a2, a3) in enumerate(frags):
                    A = np.zeros((n_tiles, 16, 16), np.float64)
                    for reg, (r0, k0) in zip((a0, a1, a2, a3),
                                             ((0, 0), (8, 0), (0, 8), (8, 8))):
                        for h in range(2):
                            val = bf16_value((reg >> (16 * h)) & 0xFFFF)
                            for tt in range(4):
                                A[:, r0:r0 + 8, k0 + 2 * tt + h] = \
                                    val[:, :, tt]
                    acc[i] += A @ B
        # C row g -> output rows of (tile i, half): bits=4 (v_lo, v_hi) of
        # byte row i; bits=8 byte rows 0 and 1
        for i in range(n_mma):
            for h in range(2):
                k = 2 * i + h if bits == 4 else h
                okk = ok[i if bits == 4 else h][:, :, 0]
                vk = v[k][:, :, 0]
                for m in range(mm):
                    y[m0 + m, vk[okk]] = acc[i][:, 8 * h:8 * h + 8, m][okk]
    return y


def exact_case(M, V, D, bits, block, seed):
    """Operands whose products cb * scale are exact in bf16 (4-bit mantissas
    each), so the kernel's two roundings change nothing and only the
    summation order differs from the f32 reference."""
    rng = np.random.default_rng(seed)
    n_codes = 16 if bits == 4 else 256

    def four_bit(shape, lo, hi):
        return (rng.integers(1, 16, shape) * 2.0 ** rng.integers(lo, hi, shape)
                ).astype(np.float32)
    cb = np.sort(four_bit(n_codes, -5, 0) * rng.choice([-1, 1], n_codes))
    scales = four_bit((V, D // block), -7, -3)
    codes = rng.integers(0, n_codes, (V, D)).astype(np.uint8)
    x = rng.standard_normal((M, D)).astype(np.float32)
    x = bf16_value(bf16_bits(x))
    return x, codes, scales, cb.astype(np.float32)


@pytest.mark.parametrize("M,V,D,bits,block,vec", [
    (5, 1040, 1152, 4, 32, 16), (5, 1040, 1152, 4, 64, 16),
    (20, 1040, 1152, 4, 128, 16), (5, 1040, 1152, 8, 32, 16),
    (5, 1040, 1152, 8, 64, 16), (20, 1040, 1152, 8, 128, 16),
    (3, 1040, 96, 4, 32, 4), (40, 512, 96, 8, 32, 8),
    (4, 1024, 1152, 4, 64, 8), (2, 1040, 160, 4, 20, 4),
])
def test_tc_lane_mapping_matches_reference(M, V, D, bits, block, vec):
    """The fragment map of the tensor-core dequant_matmul_t (loads from (g,
    t, s, c), table, prmt selectors, scale, B from naturally ordered x, C
    rows back to v) against dequant_matmul_t_ref, 1e-5 relative in f32. V =
    1040 has one nibble tile (nibble_k_tile falls back to V) and a ragged
    last warp tile, V = 1024 four tiles of 256; D = 96 and 160 end in a ragged chunk; block 20 is not a
    multiple of 16 (a scale per k16 step); M = 20 and 40 fill n8-tiles
    partly and M = 40 takes two M tiles."""
    x, codes, scales, cb = exact_case(M, V, D, bits, block, seed=M + V + D
                                      + bits + block)
    c = torch.from_numpy(codes)
    if bits == 4:
        c = pack_nibbles(c)
    s16 = torch.from_numpy(scales).to(torch.bfloat16)
    cbt = torch.from_numpy(cb)
    y = emulate_tc(bf16_bits(x), c.numpy(),
                   s16.view(torch.int16).numpy().view(np.uint16).astype(
                       np.uint32),
                   dqm.dequant_table(cbt, bits), M, V, D, block, bits, vec)
    want = dequant_matmul_t_ref(torch.from_numpy(x), c, s16, cbt, block,
                                bits).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA dequant_matmul kernel has "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_CASES = [
    # M, K, N, bits, block, lead
    (1, 768, 256, 4, 64, None), (4, 768, 2048, 4, 64, None),
    (3, 704, 384, 4, 32, None), (17, 2048, 768, 4, 128, None),
    (32, 64, 128, 4, 64, None), (1, 11008, 512, 4, 64, None),
    (4, 768, 256, 8, 64, None), (16, 704, 384, 8, 128, None),
    (5, 256, 128, 4, 64, 3), (2, 256, 256, 8, 32, 2),
    # the tensor-core kernel's edges: every n8-tile count, nibble tiles of
    # 704 and 1152 rows (half-tiles of 352 and 576 pairs), N not a multiple
    # of 128 or of a block's 16*vec columns, K splits, odd K at 8 bits,
    # M past one M tile
    (1, 6912, 1152, 4, 64, None), (5, 1152, 416, 4, 32, None),
    (8, 64, 96, 4, 32, None), (17, 6912, 256, 4, 128, None),
    (32, 1152, 6912, 4, 64, None), (32, 704, 160, 8, 32, None),
    (3, 1152, 1024, 8, 128, None), (17, 64, 2048, 8, 64, None),
    (8, 704, 4096, 4, 128, None), (5, 6912, 96, 8, 32, None),
    (1, 1152, 288, 8, 32, 2), (32, 6912, 416, 4, 32, 2),
    (3, 31, 64, 8, 32, None), (40, 256, 384, 4, 64, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits,block,lead", CUDA_CASES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, M, K, N, bits, block,
                                      lead, x_dtype):
    ops_np = make_case(M, K, N, bits, block, seed=M + K + N, lead=lead)
    args = torch_operands(*ops_np, bits, x_dtype, device=cuda_device)
    before = dqm.launches
    y = ops.dequant_matmul(*args, block=block, bits=bits)
    torch.cuda.synchronize()
    assert dqm.launches == before + 1
    y_plain = dequant_matmul_ref(*args, block, bits)
    assert y.dtype == x_dtype and y.shape == y_plain.shape
    ref = y_plain.float().cpu().numpy()
    t = tol(ref, x_dtype)
    if x_dtype == torch.bfloat16:
        t["rtol"] = 1.6e-2   # the plain version rounds to bf16 too
    np.testing.assert_allclose(y.float().cpu().numpy(), ref, **t)
    # K-split partials are summed in a fixed order: reruns are bitwise equal
    assert torch.equal(y, ops.dequant_matmul(*args, block=block, bits=bits))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bits", [(4, 11008, 512, 4), (4, 4096, 4096, 4),
                                        (32, 6912, 1152, 4),
                                        (4, 4096, 1024, 8)])
def test_split_k_calls_are_bitwise_equal(cuda_device, M, K, N, bits):
    """The K splits are combined inside the launch in split order: calls on
    the same inputs give bitwise-equal outputs, and the combine leaves every
    counter of the workspace at 0."""
    ops_np = make_case(M, K, N, bits, 64, seed=K + N)
    args = torch_operands(*ops_np, bits, torch.bfloat16, device=cuda_device)
    _, geo, _, _ = dqm._geometry(True, 1, M, K, N, bits, 8,
                                 cuda_device.index or 0)
    assert geo.splits > 1
    ys = [ops.dequant_matmul(*args, block=64, bits=bits) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    counters = dqm._workspaces[(ys[0].device.index, stream)][1]
    assert not counters.any()
    y_plain = dequant_matmul_ref(*args, 64, bits)
    ref = y_plain.float().cpu().numpy()
    t = tol(ref, torch.bfloat16)
    t["rtol"] = 1.6e-2
    np.testing.assert_allclose(ys[0].float().cpu().numpy(), ref, **t)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [4, 8])
def test_codes_aligned_to_4_bytes_take_narrower_loads(cuda_device, offset):
    """Codes that are 4-byte but not 8-byte aligned (a view into a larger
    buffer) run with 4-byte code loads, 8-byte aligned ones with 8-byte
    loads, with the same result."""
    M, K, N, bits = 4, 1152, 4096, 4
    x, codes, scales, cb = torch_operands(
        *make_case(M, K, N, bits, 64, seed=offset), bits, torch.bfloat16,
        device=cuda_device)
    buf = torch.empty(codes.numel() + 32, dtype=torch.uint8,
                      device=cuda_device)
    base = -buf.data_ptr() % 16 + offset
    shifted = buf[base:base + codes.numel()].view(codes.shape)
    shifted.copy_(codes)
    assert shifted.data_ptr() % 16 == offset
    # 8-byte code loads where the codes are 8-byte aligned, else 4
    assert dqm._geometry(True, 1, M, K, N, bits, 8, 0)[1].vec == 8
    assert dqm._geometry(True, 1, M, K, N, bits, offset, 0)[1].vec == offset
    y = ops.dequant_matmul(x, shifted, scales, cb, block=64, bits=bits)
    y_aligned = ops.dequant_matmul(x, codes, scales, cb, block=64, bits=bits)
    torch.cuda.synchronize()
    y_plain = dequant_matmul_ref(x, codes, scales, cb, 64, bits)
    ref = y_plain.float().cpu().numpy()
    t = tol(ref, torch.bfloat16)
    t["rtol"] = 1.6e-2
    np.testing.assert_allclose(y.float().cpu().numpy(), ref, **t)
    np.testing.assert_allclose(y_aligned.float().cpu().numpy(), ref, **t)

