"""The port's dequant_matmul: its plain torch version against the JAX
reference (the jnp oracle and the Pallas body in interpret mode) on the CPU,
and the CUDA kernel against the plain version on the card.

The reference modules are imported inside the tests (``pytest.importorskip``)
so that the card-only tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.nibble import pack_nibbles
from repro_torch.kernels import ops
from repro_torch.kernels import build
from repro_torch.kernels.dequant_matmul import dequant_matmul as dqm
from repro_torch.kernels.dequant_matmul.ref import dequant_matmul_ref


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
        # paper-100m wk (K=768, N=256) at decode: 2 column tiles, 3 chunks
        assert dqm.choose_splits(1, 4, 768, 256, 4, 256, 4, 132) == 3
        # deepseek-7b unembed: 800 column tiles already fill 132 SMs
        assert dqm.choose_splits(1, 4, 4096, 102400, 4, 256, 4, 132) == 1
        # deepseek-7b wq: 32 column tiles, 16 chunks, 9 splits for 264 blocks
        assert dqm.choose_splits(1, 4, 4096, 4096, 4, 256, 4, 132) == 9


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
