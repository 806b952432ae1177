// Block-absmax quantisation for Hopper (sm_90a): per (row, block) of x,
//   scale = absmax rounded to bf16 away from zero (one bf16 ulp up when the
//           round-to-nearest cast fell below the absmax),
//   code  = number of codebook midpoints strictly below x / scale
//           (a zero scale divides by 1.0),
// writing uint8 codes and f32 scales, for one tensor or for two (the fresh
// k and v rows of one attention layer) in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_quant/
// block_quant.py:block_quant (body _kernel, _round_away_bf16); the function
// it computes is the oracle block_quant_ref, and its codes and scales equal
// the plain version's bit for bit: the division is IEEE-rounded (__fdiv_rn,
// no --use_fast_math), the absmax is exact in any order, and the midpoints
// are (cb[i] + cb[i+1]) * 0.5 in f32 as the reference forms them.
//
// Bound. On the serving path it quantises the fresh K and V rows of a layer
// (block = head_dim) on their way into the cache: a few KB per call, a
// byte bound of tens of nanoseconds. The launch and the chain of dependent
// memory round trips inside the kernel set its time, not bandwidth or
// arithmetic.
//
// Design, for latency.
// * One launch per layer: the call takes up to two tensors (k and v) with
//   one shared list of output rows, so a decode step makes one launch per
//   attention layer instead of two.
// * A group of lanes per (tensor, row, block) segment, each lane one 16-byte
//   chunk of x (8 bf16 or 4 f32): a 256-wide bf16 row is one warp's single
//   load, a 64-wide row 8 lanes' (four rows per warp). Every independent
//   global load -- the lane's x chunks, its output row and the codebook --
//   is issued before the first value is used, so the kernel waits on one
//   memory round trip, not a chain of them.
// * <= 16 codes (q4): the midpoints live in registers and a code is a
//   branch-free count of 15 compares; a lane packs its 8 codes into one
//   32-bit store (byte j = code 2j low nibble | code 2j+1 high nibble).
// * More codes (q8): the midpoints sit in shared memory, and a code starts
//   from an arithmetic guess (the midpoints of linspace(-1, 1, 256) are
//   evenly spaced) that is corrected against the exact f32 midpoints until
//   it counts the midpoints strictly below the value, so ties resolve as in
//   the reference for any sorted codebook. A lane stores its 8 codes in one
//   8-byte store.
// * Vector loads and stores need 16-byte aligned rows and a block of whole
//   chunks; the wrapper picks the scalar instance otherwise.
// * `pack` stores 4-bit codes pairwise along the row, and `dest_rows`
//   scatters input row r to output row dest_rows[r] (the cache write), so
//   the codes land in the cache directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHold = 2;     // 16-byte chunks a lane keeps in registers
constexpr int kSmall = 16;   // codebooks up to this size: registers

struct Operand {
  const void* x;      // (rows, cols) bf16 or f32, contiguous
  uint8_t* codes;     // output rows of code_cols bytes
  float* scales;      // output rows of cols / block f32
};

struct Args {
  Operand op[2];
  const int64_t* dest;   // output row of each input row, or null (row r)
  const float* codebook;
  int n_tensors, rows, cols, block, n_codes, pack, group;
};

__device__ __forceinline__ float round_away_bf16(float s) {
  const __nv_bfloat16 s16 = __float2bfloat16_rn(s);
  const float r = __bfloat162float(s16);
  if (r < s)
    return __bfloat162float(
        __ushort_as_bfloat16((unsigned short)(__bfloat16_as_ushort(s16) + 1)));
  return r;
}

template <typename XT>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPer = 8;
  static __device__ __forceinline__ void vec(const __nv_bfloat16* p,
                                             float (&v)[kPer]) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};
template <>
struct Elem<float> {
  static constexpr int kPer = 4;
  static __device__ __forceinline__ void vec(const float* p,
                                             float (&v)[kPer]) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  static __device__ __forceinline__ float one(const float* p) { return *p; }
};

// chunk c (elements [c*kPer, c*kPer + kPer) of the block) into v; zeros
// where the block ends or when !ok
template <typename XT, bool kVec>
__device__ __forceinline__ void load_chunk(const XT* xb, int c, int block,
                                           bool ok,
                                           float (&v)[Elem<XT>::kPer]) {
  constexpr int P = Elem<XT>::kPer;
  if constexpr (kVec) {
    if (ok) {
      Elem<XT>::vec(xb + c * P, v);
      return;
    }
#pragma unroll
    for (int e = 0; e < P; ++e) v[e] = 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e)
      v[e] = ok && c * P + e < block ? Elem<XT>::one(xb + c * P + e) : 0.f;
  }
}

// number of midpoints strictly below v
template <bool kRegs>
__device__ __forceinline__ int code_of(float v, const float (&mr)[kSmall - 1],
                                       const float* ms, int n_mids, float m0,
                                       float inv) {
  if constexpr (kRegs) {
    int c = 0;
#pragma unroll
    for (int i = 0; i < kSmall - 1; ++i) c += v > mr[i];   // +inf pads
    return c;
  }
  const float t = (v - m0) * inv;
  int g = t >= 0.f ? min((int)t, n_mids - 1) + 1 : 0;
  while (g > 0 && !(ms[g - 1] < v)) --g;
  while (g < n_mids && ms[g] < v) ++g;
  return g;
}

template <int kBytes>
__device__ __forceinline__ void store_bytes(uint8_t* p, uint64_t w) {
  if constexpr (kBytes == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2((uint32_t)w, (uint32_t)(w >> 32));
  else if constexpr (kBytes == 4)
    *reinterpret_cast<uint32_t*>(p) = (uint32_t)w;
  else if constexpr (kBytes == 2)
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)w;
  else
    *p = (uint8_t)w;
}

// codes of one chunk, stored at the chunk's place in the code row
template <typename XT, bool kVec, bool kRegs>
__device__ __forceinline__ void quantise_chunk(
    const float (&v)[Elem<XT>::kPer], int c, int block, float safe, int pack,
    uint8_t* crow, const float (&mr)[kSmall - 1], const float* ms, int n_mids,
    float m0, float inv) {
  constexpr int P = Elem<XT>::kPer;
  int q[P];
#pragma unroll
  for (int e = 0; e < P; ++e)
    q[e] = code_of<kRegs>(__fdiv_rn(v[e], safe), mr, ms, n_mids, m0, inv);
  uint64_t w = 0;
  if (pack) {
#pragma unroll
    for (int j = 0; j < P / 2; ++j)
      w |= (uint64_t)(q[2 * j] | (q[2 * j + 1] << 4)) << (8 * j);
    uint8_t* p = crow + c * (P / 2);
    if constexpr (kVec) {
      store_bytes<P / 2>(p, w);
    } else {
      for (int j = 0; j < P / 2 && c * P + 2 * j < block; ++j)
        p[j] = (uint8_t)(w >> (8 * j));
    }
  } else {
#pragma unroll
    for (int e = 0; e < P; ++e) w |= (uint64_t)(q[e] & 0xff) << (8 * e);
    uint8_t* p = crow + c * P;
    if constexpr (kVec) {
      store_bytes<P>(p, w);
    } else {
      for (int e = 0; e < P && c * P + e < block; ++e)
        p[e] = (uint8_t)(w >> (8 * e));
    }
  }
}

template <typename XT, bool kVec, bool kRegs>
__global__ void __launch_bounds__(kThreads) block_quant_kernel(const Args a) {
  constexpr int P = Elem<XT>::kPer;
  __shared__ float ms[kRegs ? 1 : 255];
  const int lane = threadIdx.x & 31;
  const int group = a.group;                  // lanes per segment, 2^k <= 32
  const int sl = lane & (group - 1);          // lane within its segment
  const long long seg =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / group) +
      lane / group;
  const int n_sb = a.cols / a.block;
  const long long per_tensor = (long long)a.rows * n_sb;
  const bool live = seg < a.n_tensors * per_tensor;
  const int t = live && seg >= per_tensor ? 1 : 0;
  const long long rem = live ? seg - t * per_tensor : 0;
  const int r = (int)(rem / n_sb), sb = (int)(rem % n_sb);
  const Operand op = t ? a.op[1] : a.op[0];
  const int n_mids = a.n_codes - 1;
  const int n_chunks = (a.block + P - 1) / P;

  // every independent global load first: the codebook, the output row and
  // the lane's chunks of x
  float cb[kSmall];
  float cb_lo = 0.f, cb_hi = 0.f;
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kSmall; ++i) cb[i] = __ldg(a.codebook + min(i, n_mids));
  } else if (threadIdx.x < n_mids) {
    cb_lo = __ldg(a.codebook + threadIdx.x);
    cb_hi = __ldg(a.codebook + threadIdx.x + 1);
  }
  const long long dst =
      !live ? 0
      : a.dest ? __ldg(reinterpret_cast<const long long*>(a.dest) + r)
               : r;
  const XT* xb = static_cast<const XT*>(op.x) + (size_t)r * a.cols +
                 (size_t)sb * a.block;
  float v[kHold][P];
#pragma unroll
  for (int i = 0; i < kHold; ++i)
    load_chunk<XT, kVec>(xb, sl + i * group, a.block,
                         live && sl + i * group < n_chunks, v[i]);

  float mr[kSmall - 1];
  float m0 = 0.f, inv = 0.f;
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < kSmall - 1; ++i)
      mr[i] = i < n_mids ? (cb[i + 1] + cb[i]) * 0.5f : INFINITY;
  } else {
    if (threadIdx.x < n_mids) ms[threadIdx.x] = (cb_hi + cb_lo) * 0.5f;
    __syncthreads();
    m0 = ms[0];
    const float span = ms[n_mids - 1] - m0;
    inv = span > 0.f ? (float)(n_mids - 1) / span : 0.f;
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kHold; ++i)
#pragma unroll
    for (int e = 0; e < P; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
  for (int c = sl + kHold * group; live && c < n_chunks; c += group) {
    float w[P];
    load_chunk<XT, kVec>(xb, c, a.block, true, w);
#pragma unroll
    for (int e = 0; e < P; ++e) amax = fmaxf(amax, fabsf(w[e]));
  }
  for (int off = group >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (!live) return;

  const float s = round_away_bf16(amax);
  const float safe = s == 0.f ? 1.f : s;
  if (sl == 0) op.scales[dst * n_sb + sb] = s;
  uint8_t* crow = op.codes + (size_t)dst * (a.pack ? a.cols / 2 : a.cols) +
                  (size_t)sb * (a.pack ? a.block / 2 : a.block);
#pragma unroll
  for (int i = 0; i < kHold; ++i)
    if (sl + i * group < n_chunks)
      quantise_chunk<XT, kVec, kRegs>(v[i], sl + i * group, a.block, safe,
                                      a.pack, crow, mr, ms, n_mids, m0, inv);
  for (int c = sl + kHold * group; c < n_chunks; c += group) {
    float w[P];
    load_chunk<XT, kVec>(xb, c, a.block, true, w);
    quantise_chunk<XT, kVec, kRegs>(w, c, a.block, safe, a.pack, crow, mr,
                                    ms, n_mids, m0, inv);
  }
}

__global__ void empty_kernel() {}

template <typename XT>
int launch(const Args& a, int vec, cudaStream_t s) {
  constexpr int P = Elem<XT>::kPer;
  Args b = a;
  const int n_chunks = (a.block + P - 1) / P;
  b.group = 1;
  while (b.group < 32 && b.group < n_chunks) b.group <<= 1;
  const long long n_seg =
      (long long)a.n_tensors * a.rows * (a.cols / a.block);
  const long long per_block = (long long)kWarps * (32 / b.group);
  const long long blocks = (n_seg + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool regs = a.n_codes <= kSmall;
  const dim3 grid((unsigned)blocks);
  if (vec && regs)
    block_quant_kernel<XT, true, true><<<grid, kThreads, 0, s>>>(b);
  else if (vec)
    block_quant_kernel<XT, true, false><<<grid, kThreads, 0, s>>>(b);
  else if (regs)
    block_quant_kernel<XT, false, true><<<grid, kThreads, 0, s>>>(b);
  else
    block_quant_kernel<XT, false, false><<<grid, kThreads, 0, s>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`. x0 (and x1 when n_tensors == 2) (rows, cols) in bf16
// or f32, contiguous; codebook (n_codes,) f32, sorted ascending; tensor i
// writes codes_i, with (cols or cols/2 when `pack`) bytes per row, and
// scales_i f32, with cols/block per row, both indexed by output row
// (dest_rows[r], int64, shared by both tensors, or r when dest_rows is
// null). `vec` = 1 asks for 16-byte loads and whole-chunk code stores: the
// caller guarantees 16-byte aligned x, a block of whole 16-byte chunks and
// codes aligned to one chunk's code bytes. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int block_quant_launch(const void* x0, const void* x1,
                                  void* codes0, void* codes1, void* scales0,
                                  void* scales1, const void* dest_rows,
                                  const void* codebook, int x_is_bf16,
                                  int n_tensors, int rows, int cols,
                                  int block, int n_codes, int pack, int vec,
                                  void* stream) {
  if (n_tensors < 1 || n_tensors > 2 || rows < 1 || cols < 1 || block < 1 ||
      cols % block || n_codes < 2 || n_codes > 256 ||
      (pack && (n_codes > kSmall || block % 2)) || !x0 || !codes0 ||
      !scales0 || !codebook || (n_tensors == 2 && (!x1 || !codes1 || !scales1)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.op[0] = {x0, static_cast<uint8_t*>(codes0), static_cast<float*>(scales0)};
  a.op[1] = n_tensors == 2 ? Operand{x1, static_cast<uint8_t*>(codes1),
                                     static_cast<float*>(scales1)}
                           : a.op[0];
  a.dest = static_cast<const int64_t*>(dest_rows);
  a.codebook = static_cast<const float*>(codebook);
  a.n_tensors = n_tensors;
  a.rows = rows;
  a.cols = cols;
  a.block = block;
  a.n_codes = n_codes;
  a.pack = pack;
  a.group = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch<__nv_bfloat16>(a, vec, s) : launch<float>(a, vec, s);
}

// An empty kernel on the same route (ctypes, one launch on `stream`): the
// launch floor that a launch-bound kernel's time is read against.
extern "C" int block_quant_floor_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
