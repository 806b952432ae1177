// Fused dequantise-matmul for Hopper (sm_90a): y = x @ W with
//   W[k, n] = codebook[code[k, n]] * scale[k, n / block],
// accumulated in f32 and written in x's dtype (bf16 or f32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_matmul/
// dequant_matmul.py:_kernel (with _decode_tile/_dequant_tile/_unpack); the
// function it computes is the oracle kernels/dequant_matmul/ref.py
// dequant_matmul_ref, not the Pallas tiling.
//
// Bound. Serving calls it with M = slots (decode) or slots * chunk
// (prefill), M <= 32, so it is a GEMV-like stream of the packed weight:
//   bytes = K*N/2 (bits=4) or K*N (bits=8)   codes
//         + K*(N/block)*2                     bf16 scales
//         + M*K*sizeof(x) + M*N*sizeof(out)   activations
// against 2*M*K*N flops, i.e. about 4*M flops per code byte at 4 bits:
// far below the ~295 flop/byte ridge of an H100, so memory bandwidth bounds
// it and the design aims only at streaming the codes once at full width.
//
// Design.
// * One block per (128 output columns, M tile of MT <= 16 rows, lead index,
//   K split). Each lane owns 4 adjacent columns and reads their 4 code bytes
//   as one 32-bit load, so a warp reads 128 contiguous bytes of a code row.
// * The 8 warps of a block take interleaved code rows of each 128-row chunk;
//   a warp issues all 16 of its code-row loads (and their scales) before the
//   chunk's activations are staged, so they are in flight together. Each
//   lane keeps MT x 4 partial sums in registers; the warps are summed
//   through shared memory at the end. Small-N shapes are additionally split along K across
//   blocks ("splits", chosen by the wrapper to fill the SMs); each split
//   writes an f32 partial and a second kernel sums the splits in a fixed
//   order, so results do not depend on scheduling.
// * The codebook (<= 256 f32) lives in shared memory; the activation rows of
//   the current K chunk are staged in shared memory as f32 and read by every
//   lane as a broadcast.
// * bits=4 codes use the per-tile half interleave of core/nibble.py: in byte
//   row r of nibble tile t the low nibble is logical row t*tile + r and the
//   high nibble row t*tile + tile/2 + r. The wrapper passes `tile`; chunks
//   never straddle a tile half, so one byte load feeds both rows.
// * The ragged edges (M rows, N columns) are masked; nothing is padded.
// Tensor cores, TMA and a deeper load pipeline are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = 4;
constexpr int kTileN = 32 * kColsPerLane;  // output columns per block
constexpr int kChunk = 128;                // code rows staged per chunk
constexpr int kRowsPerWarp = kChunk / kWarps;

struct Geometry {
  int E, M, K, N, block, tile, n_codes, splits;
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

template <int BITS, int MT, typename XT>
__global__ void __launch_bounds__(kThreads)
    dequant_matmul_kernel(const XT* __restrict__ x,
                          const uint8_t* __restrict__ codes,
                          const __nv_bfloat16* __restrict__ scales,
                          const float* __restrict__ codebook,
                          XT* __restrict__ out, float* __restrict__ partial,
                          Geometry g) {
  __shared__ float cb_s[256];
  __shared__ float xs[BITS == 4 ? 2 : 1][MT][kChunk];
  __shared__ float red[kWarps][kTileN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kTileN + lane * kColsPerLane;
  const int m0 = blockIdx.y * MT;
  const int e = blockIdx.z / g.splits;
  const int split = blockIdx.z % g.splits;
  const bool col_ok = n0 < g.N;  // N % 4 == 0: a lane's 4 columns all fit

  // Chunks of code rows: bits=4 walks each nibble tile's byte rows (both
  // halves at once), bits=8 walks K as one tile without a high half.
  const int half = BITS == 4 ? g.tile / 2 : g.K;
  const int n_tiles = BITS == 4 ? g.K / g.tile : 1;
  const int per_tile = (half + kChunk - 1) / kChunk;
  const int n_chunks = n_tiles * per_tile;
  const int c_begin = (int)((long long)n_chunks * split / g.splits);
  const int c_end = (int)((long long)n_chunks * (split + 1) / g.splits);

  const int n_sblocks = g.N / g.block;
  const int k_rows = BITS == 4 ? g.K / 2 : g.K;
  const XT* xe = x + (size_t)e * g.M * g.K;
  const uint8_t* ce = codes + (size_t)e * k_rows * g.N;
  const __nv_bfloat16* se =
      scales + (size_t)e * g.K * n_sblocks + (col_ok ? n0 / g.block : 0);

  for (int i = tid; i < 256; i += kThreads)
    cb_s[i] = i < g.n_codes ? codebook[i] : 0.f;

  float acc[MT][kColsPerLane];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q) acc[m][q] = 0.f;

  for (int c = c_begin; c < c_end; ++c) {
    const int t = c / per_tile;
    const int r0 = (c % per_tile) * kChunk;
    const int rc = min(kChunk, half - r0);
    const int byte_row = t * half + r0;
    const int k_lo = (BITS == 4 ? t * g.tile : 0) + r0;
    const int k_hi = k_lo + half;

    // Issue this warp's code and scale loads for the whole chunk first, so
    // they are in flight while the activations are staged.
    uint32_t words[kRowsPerWarp];
    float s_lo[kRowsPerWarp], s_hi[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int j = warp + u * kWarps;
      const bool ok = col_ok && j < rc;
      words[u] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
                          ce + (size_t)(byte_row + j) * g.N + n0))
                    : 0u;
      s_lo[u] = ok ? __bfloat162float(se[(size_t)(k_lo + j) * n_sblocks])
                   : 0.f;
      if constexpr (BITS == 4)
        s_hi[u] = ok ? __bfloat162float(se[(size_t)(k_hi + j) * n_sblocks])
                     : 0.f;
    }

    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = tid; i < MT * kChunk; i += kThreads) {
      const int m = i / kChunk, r = i % kChunk;
      const bool ok = (m0 + m < g.M) && (r < rc);
      const XT* row = xe + (size_t)(m0 + m) * g.K;
      xs[0][m][r] = ok ? to_f32(row[k_lo + r]) : 0.f;
      if constexpr (BITS == 4) xs[1][m][r] = ok ? to_f32(row[k_hi + r]) : 0.f;
    }
    __syncthreads();

    // Rows past rc carry zero codes, scales and activations: no branch, so
    // the loop stays fully unrolled and words/s_lo/s_hi stay in registers.
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int j = warp + u * kWarps;
      float w_lo[kColsPerLane], w_hi[kColsPerLane];
#pragma unroll
      for (int q = 0; q < kColsPerLane; ++q) {
        const uint32_t b = (words[u] >> (8 * q)) & 0xFFu;
        if constexpr (BITS == 4) {
          w_lo[q] = cb_s[b & 0xFu] * s_lo[u];
          w_hi[q] = cb_s[b >> 4] * s_hi[u];
        } else {
          w_lo[q] = cb_s[b] * s_lo[u];
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = xs[0][m][j];
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q)
          acc[m][q] = fmaf(xl, w_lo[q], acc[m][q]);
        if constexpr (BITS == 4) {
          const float xh = xs[1][m][j];
#pragma unroll
          for (int q = 0; q < kColsPerLane; ++q)
            acc[m][q] = fmaf(xh, w_hi[q], acc[m][q]);
        }
      }
    }
  }

  // Sum the warps' partials column by column, one output row at a time.
  const int n_out = blockIdx.x * kTileN + tid;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kColsPerLane; ++q)
      red[warp][lane * kColsPerLane + q] = acc[m][q];
    __syncthreads();
    if (tid < kTileN && n_out < g.N && m0 + m < g.M) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][tid];
      const size_t o = ((size_t)e * g.M + m0 + m) * g.N + n_out;
      if (g.splits == 1)
        out[o] = from_f32<XT>(sum);
      else
        partial[(size_t)split * g.E * g.M * g.N + o] = sum;
    }
  }
}

template <typename XT>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  XT* __restrict__ out, int splits,
                                  size_t count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += partial[(size_t)s * count + i];
  out[i] = from_f32<XT>(sum);
}

template <int BITS, int MT, typename XT>
void launch_main(const void* x, const void* codes, const void* scales,
                 const void* codebook, void* out, void* partial,
                 const Geometry& g, cudaStream_t stream) {
  dim3 grid((g.N + kTileN - 1) / kTileN, (g.M + MT - 1) / MT,
            g.E * g.splits);
  dequant_matmul_kernel<BITS, MT, XT><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(scales),
      static_cast<const float*>(codebook), static_cast<XT*>(out),
      static_cast<float*>(partial), g);
}

template <int BITS, typename XT>
void dispatch_mt(int mt, const void* x, const void* codes, const void* scales,
                 const void* codebook, void* out, void* partial,
                 const Geometry& g, cudaStream_t stream) {
  switch (mt) {
    case 1: launch_main<BITS, 1, XT>(x, codes, scales, codebook, out, partial, g, stream); break;
    case 2: launch_main<BITS, 2, XT>(x, codes, scales, codebook, out, partial, g, stream); break;
    case 4: launch_main<BITS, 4, XT>(x, codes, scales, codebook, out, partial, g, stream); break;
    case 8: launch_main<BITS, 8, XT>(x, codes, scales, codebook, out, partial, g, stream); break;
    default: launch_main<BITS, 16, XT>(x, codes, scales, codebook, out, partial, g, stream); break;
  }
}

template <typename XT>
void dispatch_bits(int bits, int mt, const void* x, const void* codes,
                   const void* scales, const void* codebook, void* out,
                   void* partial, const Geometry& g, cudaStream_t stream) {
  if (bits == 4)
    dispatch_mt<4, XT>(mt, x, codes, scales, codebook, out, partial, g, stream);
  else
    dispatch_mt<8, XT>(mt, x, codes, scales, codebook, out, partial, g, stream);
}

}  // namespace

// Launch on `stream`. x (E, M, K), codes (E, K/2 or K, N) uint8, scales
// (E, K, N/block) bf16, codebook (n_codes,) f32, out (E, M, N) in x's dtype;
// `partial` is f32 scratch of splits*E*M*N elements when splits > 1.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int dequant_matmul_launch(const void* x, const void* codes,
                                     const void* scales, const void* codebook,
                                     void* out, void* partial, int x_is_bf16,
                                     int E, int M, int K, int N, int block,
                                     int bits, int tile, int n_codes,
                                     int splits, void* stream) {
  if (E < 1 || M < 1 || K < 1 || N < 1 || block < 4 || N % block != 0 ||
      (bits != 4 && bits != 8) || n_codes < 1 || n_codes > 256 ||
      splits < 1 || (bits == 4 && (tile < 2 || tile % 2 || K % tile)) ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geometry g{E, M, K, N, block, tile, n_codes, splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int mt = 1;  // M-tile height: 1, 2, 4, 8 or 16
  while (mt < M && mt < 16) mt *= 2;
  if (x_is_bf16)
    dispatch_bits<__nv_bfloat16>(bits, mt, x, codes, scales, codebook, out,
                                 partial, g, s);
  else
    dispatch_bits<float>(bits, mt, x, codes, scales, codebook, out, partial,
                         g, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)E * M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  if (x_is_bf16)
    sum_splits_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out),
        splits, count);
  else
    sum_splits_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), splits,
        count);
  return (int)cudaGetLastError();
}
