// Block-absmax quantisation for Hopper (sm_90a): per (row, block) of x,
//   scale = absmax rounded to bf16 away from zero (one bf16 ulp up when the
//           round-to-nearest cast fell below the absmax),
//   code  = number of codebook midpoints strictly below x / scale
//           (a zero scale divides by 1.0),
// writing uint8 codes and f32 scales.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_quant/
// block_quant.py:block_quant (body _kernel, _round_away_bf16); the function
// it computes is the oracle block_quant_ref, and its codes and scales equal
// the plain version's bit for bit: the division is IEEE-rounded (no
// --use_fast_math), the absmax is exact in any order, and the midpoints are
// (cb[i] + cb[i+1]) * 0.5 in f32 as the reference forms them.
//
// Bound. On the serving path it quantises each fresh K or V row (block =
// head_dim) before it is written to the cache: a few KB per call, so the
// launch, not the card's bandwidth or arithmetic, sets its time. The byte
// bound is rows*cols*sizeof(x) read plus the codes and scales written.
//
// Design.
// * One warp per (row, block) segment, grid-stride: lanes stride the block,
//   the absmax is a warp-shuffle max, lane 0 writes the scale.
// * The sorted midpoints (<= 255 f32) sit in shared memory: a branch-free
//   count over them for <= 16 codes (q4), a binary search above (q8).
// * Optional fusions, each producing the same bytes as the unfused path:
//   `pack` stores 4-bit codes pairwise along the row (byte j = code 2j in
//   the low nibble, 2j+1 in the high nibble, the quantised KV cache's
//   layout), and `dest_rows` scatters input row r to output row
//   dest_rows[r] (the cache write), so the codes land in the cache directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_away_bf16(float s) {
  const __nv_bfloat16 s16 = __float2bfloat16_rn(s);
  const float r = __bfloat162float(s16);
  if (r < s)
    return __bfloat162float(
        __ushort_as_bfloat16((unsigned short)(__bfloat16_as_ushort(s16) + 1)));
  return r;
}

// number of midpoints strictly below v (mids sorted ascending)
__device__ __forceinline__ int code_of(float v, const float* mids, int n) {
  if (n <= 16) {
    int c = 0;
    for (int i = 0; i < n; ++i) c += v > mids[i];
    return c;
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (mids[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
    block_quant_kernel(const XT* __restrict__ x,
                       const float* __restrict__ codebook,
                       uint8_t* __restrict__ codes, float* __restrict__ scales,
                       const int64_t* __restrict__ dest_rows, int rows,
                       int cols, int block, int n_codes, int pack) {
  __shared__ float mids[255];
  const int n_mids = n_codes - 1;
  for (int i = threadIdx.x; i < n_mids; i += kThreads)
    mids[i] = (codebook[i + 1] + codebook[i]) * 0.5f;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_sb = cols / block;
  const int code_cols = pack ? cols / 2 : cols;
  const long long n_seg = (long long)rows * n_sb;
  for (long long seg = (long long)blockIdx.x * kWarps + warp; seg < n_seg;
       seg += (long long)gridDim.x * kWarps) {
    const int r = (int)(seg / n_sb), sb = (int)(seg % n_sb);
    const XT* xr = x + (size_t)r * cols + (size_t)sb * block;
    float amax = 0.f;
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = round_away_bf16(amax);
    const float safe = s == 0.f ? 1.f : s;
    const long long dst = dest_rows ? dest_rows[r] : r;
    if (lane == 0) scales[dst * n_sb + sb] = s;
    uint8_t* crow = codes + (size_t)dst * code_cols;
    if (pack) {
      crow += (size_t)sb * (block / 2);
      for (int j = lane; j < block / 2; j += 32) {
        const int lo = code_of(to_f32(xr[2 * j]) / safe, mids, n_mids);
        const int hi = code_of(to_f32(xr[2 * j + 1]) / safe, mids, n_mids);
        crow[j] = (uint8_t)(lo | (hi << 4));
      }
    } else {
      crow += (size_t)sb * block;
      for (int i = lane; i < block; i += 32)
        crow[i] = (uint8_t)code_of(to_f32(xr[i]) / safe, mids, n_mids);
    }
  }
}

}  // namespace

// Launch on `stream`. x (rows, cols) in bf16 or f32; codebook (n_codes,) f32,
// sorted ascending; codes uint8 with (cols or cols/2 when `pack`) bytes per
// row and scales f32 with cols/block per row, both indexed by output row
// (dest_rows[r], int64, or r when dest_rows is null). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int block_quant_launch(const void* x, const void* codebook,
                                  void* codes, void* scales,
                                  const void* dest_rows, int x_is_bf16,
                                  int rows, int cols, int block, int n_codes,
                                  int pack, int n_blocks, void* stream) {
  if (rows < 1 || cols < 1 || block < 1 || cols % block || n_codes < 2 ||
      n_codes > 256 || n_blocks < 1 ||
      (pack && (n_codes > 16 || block % 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* dr = static_cast<const int64_t*>(dest_rows);
  if (x_is_bf16)
    block_quant_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(codebook), static_cast<uint8_t*>(codes),
        static_cast<float*>(scales), dr, rows, cols, block, n_codes, pack);
  else
    block_quant_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(codebook),
        static_cast<uint8_t*>(codes), static_cast<float*>(scales), dr, rows,
        cols, block, n_codes, pack);
  return (int)cudaGetLastError();
}
