// Transposed fused dequantise-matmul for Hopper (sm_90a): y = x @ W.T with
//   W[v, d] = codebook[code[v, d]] * scale[v, d / block],
// x (M, D), y (M, V); accumulated in f32 and written in x's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_matmul/
// dequant_matmul.py:dequant_matmul_t (body _kernel_t); the function it
// computes is the oracle dequant_matmul_t_ref. This is the tied-embeddings
// unembed: the packed (V, D) embedding table serves the logits directly, so
// no transposed or dense copy of the table exists.
//
// Bound. At serving sizes (M = slots or slots * chunk <= 32, V = 262144,
// D = 1152 for gemma3-1b) it streams the packed table once:
//   bytes = V*D/2 (bits=4) or V*D (bits=8) codes + V*(D/block)*2 bf16 scales
//         + M*D*sizeof(x) + M*V*sizeof(out)
// against 2*M*V*D flops, about 4*M flops per code byte at 4 bits: memory
// bandwidth bounds it, and the design aims at streaming the codes once.
//
// Design.
// * The contraction runs along each code row's contiguous D bytes, so one
//   warp takes one byte row at a time: lanes stride D, 4 code bytes (one
//   32-bit load) each, and a warp-shuffle reduction finishes the row.
// * bits=4 codes are nibble-packed along V in the per-tile half interleave of
//   core/nibble.py: byte row t*tile/2 + r holds output rows t*tile + r (low
//   nibble) and t*tile + tile/2 + r (high nibble), so one byte row feeds two
//   outputs. bits=8 byte rows are output rows.
// * The scale varies along the contraction (one per D block), so it is
//   folded into each lane's partial sum of 4 elements (block % 4 == 0 keeps
//   them in one block) instead of scaling the weights.
// * A block stages its MT rows of x in shared memory as f32 once and then
//   walks byte rows grid-stride, warp by warp; the codebook (<= 256 f32) is
//   in shared memory. M above MT runs as further blocks along grid.y.
// Tensor cores and a deeper load pipeline are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct GeometryT {
  int M, D, V, block, tile;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(const float4& a, const float* w) {
  return a.x * w[0] + a.y * w[1] + a.z * w[2] + a.w * w[3];
}

template <int BITS, int MT, typename XT>
__global__ void __launch_bounds__(kThreads)
    dequant_matmul_t_kernel(const XT* __restrict__ x,
                            const uint8_t* __restrict__ codes,
                            const __nv_bfloat16* __restrict__ scales,
                            const float* __restrict__ codebook, int n_codes,
                            XT* __restrict__ out, GeometryT g) {
  extern __shared__ float smem[];
  float* cb_s = smem;        // 256
  float* xs = smem + 256;    // MT x D

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * MT;

  for (int i = tid; i < 256; i += kThreads)
    cb_s[i] = i < n_codes ? codebook[i] : 0.f;
  for (int i = tid; i < MT * g.D; i += kThreads) {
    const int m = i / g.D, d = i % g.D;
    xs[i] = m0 + m < g.M ? to_f32(x[(size_t)(m0 + m) * g.D + d]) : 0.f;
  }
  __syncthreads();

  const int half = g.tile / 2;
  const int byte_rows = BITS == 4 ? g.V / 2 : g.V;
  const int n_sb = g.D / g.block;
  for (int j = blockIdx.x * kWarps + warp; j < byte_rows;
       j += gridDim.x * kWarps) {
    int v_lo = j, v_hi = 0;
    if constexpr (BITS == 4) {
      v_lo = (j / half) * g.tile + j % half;
      v_hi = v_lo + half;
    }
    const uint8_t* crow = codes + (size_t)j * g.D;
    const __nv_bfloat16* s_lo = scales + (size_t)v_lo * n_sb;
    const __nv_bfloat16* s_hi = scales + (size_t)v_hi * n_sb;
    float acc_lo[MT], acc_hi[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc_lo[m] = acc_hi[m] = 0.f;

    for (int d0 = lane * 4; d0 < g.D; d0 += 128) {
      const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(crow + d0));
      const float sl = __bfloat162float(s_lo[d0 / g.block]);
      const float sh = BITS == 4 ? __bfloat162float(s_hi[d0 / g.block]) : 0.f;
      float wl[4], wh[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t b = (word >> (8 * q)) & 0xFFu;
        if constexpr (BITS == 4) {
          wl[q] = cb_s[b & 0xFu];
          wh[q] = cb_s[b >> 4];
        } else {
          wl[q] = cb_s[b];
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + m * g.D + d0);
        acc_lo[m] = fmaf(dot4(xv, wl), sl, acc_lo[m]);
        if constexpr (BITS == 4) acc_hi[m] = fmaf(dot4(xv, wh), sh, acc_hi[m]);
      }
    }

#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc_lo[m] += __shfl_xor_sync(0xffffffffu, acc_lo[m], off);
        if constexpr (BITS == 4)
          acc_hi[m] += __shfl_xor_sync(0xffffffffu, acc_hi[m], off);
      }
    }
    // every lane holds every row's sum; lane m writes row m
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (lane == (m & 31) && m0 + m < g.M) {
        XT* orow = out + (size_t)(m0 + m) * g.V;
        orow[v_lo] = from_f32<XT>(acc_lo[m]);
        if constexpr (BITS == 4) orow[v_hi] = from_f32<XT>(acc_hi[m]);
      }
    }
  }
}

template <int BITS, int MT, typename XT>
cudaError_t launch(const void* x, const void* codes, const void* scales,
                   const void* codebook, int n_codes, void* out,
                   const GeometryT& g, int n_blocks, cudaStream_t stream) {
  const size_t smem = (256 + (size_t)MT * g.D) * sizeof(float);
  auto kernel = dequant_matmul_t_kernel<BITS, MT, XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(n_blocks, (g.M + MT - 1) / MT);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const float*>(codebook), n_codes, static_cast<XT*>(out), g);
  return cudaGetLastError();
}

template <int BITS, typename XT>
cudaError_t dispatch_mt(int mt, const void* x, const void* codes,
                        const void* scales, const void* codebook, int n_codes,
                        void* out, const GeometryT& g, int n_blocks,
                        cudaStream_t s) {
  switch (mt) {
    case 1: return launch<BITS, 1, XT>(x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
    case 2: return launch<BITS, 2, XT>(x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
    case 4: return launch<BITS, 4, XT>(x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
    case 8: return launch<BITS, 8, XT>(x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
    case 16: return launch<BITS, 16, XT>(x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
    case 32: return launch<BITS, 32, XT>(x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`. x (M, D) in bf16 or f32, codes (V/2 or V, D) uint8,
// scales (V, D/block) bf16, codebook (n_codes,) f32, out (M, V) in x's
// dtype. `mt` (1..32, a power of two) is the number of x rows a block
// stages; the caller sizes it so that (256 + mt*D)*4 bytes of shared memory
// fit. Returns the cudaError_t of the launch (0 on success).
extern "C" int dequant_matmul_t_launch(const void* x, const void* codes,
                                       const void* scales,
                                       const void* codebook, void* out,
                                       int x_is_bf16, int M, int D, int V,
                                       int block, int bits, int tile,
                                       int n_codes, int mt, int n_blocks,
                                       void* stream) {
  if (M < 1 || D < 4 || V < 1 || D % 4 || block < 4 || block % 4 ||
      D % block || (bits != 4 && bits != 8) || n_codes < 1 ||
      n_codes > (bits == 4 ? 16 : 256) || n_blocks < 1 ||
      (bits == 4 && (tile < 2 || tile % 2 || V % tile)))
    return (int)cudaErrorInvalidValue;
  const GeometryT g{M, D, V, block, tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16)
    err = bits == 4 ? dispatch_mt<4, __nv_bfloat16>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s)
                    : dispatch_mt<8, __nv_bfloat16>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
  else
    err = bits == 4 ? dispatch_mt<4, float>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s)
                    : dispatch_mt<8, float>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
  return (int)err;
}
