// Fused dequantise-matmul for Hopper (sm_90a): y = x @ W with
//   W[k, n] = codebook[code[k, n]] * scale[k, n / block],
// accumulated in f32 and written in x's dtype (bf16 or f32).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_matmul/
// dequant_matmul.py:_kernel (with _decode_tile/_dequant_tile/_unpack); the
// function it computes is the oracle kernels/dequant_matmul/ref.py
// dequant_matmul_ref, not the Pallas tiling (its one-hot LUT matmul and
// select tree have no place here).
//
// Bound. Serving calls it with M = slots (decode) or slots * chunk
// (prefill), M <= 32, so it is a GEMV-like stream of the packed weight:
//   bytes = K*N/2 (bits=4) or K*N (bits=8)   codes
//         + K*(N/block)*2                     bf16 scales
//         + M*K*sizeof(x) + M*N*sizeof(out)   activations
// against 2*M*K*N flops, i.e. about 4*M flops per code byte at 4 bits:
// far below the ~295 flop/byte ridge of an H100, so memory bandwidth bounds
// it. Two kernels live here:
//
// 1. mma::kernel, bf16 activations (every served config). Tensor cores
//    through mma.sync.m16n8k16 (bf16 in, f32 accumulate), so the work per
//    code byte is one table read, one bf16x2 multiply and a share of an MMA:
//  * The weight is the A operand (16 output columns x 16 k), the tokens the
//    n8 operand: ceil(M/8) MMAs per A fragment (M = 32 reuses it 4 times);
//    rows past M are masked, never padded in memory.
//  * The order of k inside the dot product is free, and so is which column
//    an MMA row stands for. In the core/nibble.py layout the byte at (byte
//    row r, column n) holds W[k_lo, n] in its low nibble and W[k_hi, n] in
//    its high nibble (k_lo = t*tile + r', k_hi = k_lo + tile/2), so one byte
//    is one bf16x2 A register: the "k-pair" (k_lo, k_hi) of column n. The
//    activations are staged in shared memory in the same pair order, as
//    bf16x2 (x[m, k_lo], x[m, k_hi]), and the B fragments read from there.
//    bits=8 pairs byte rows 2p and 2p+1 and joins their two table entries
//    with one prmt. A lane of MMA group g loads VEC adjacent columns of one
//    byte row with one VEC-byte load: column c0 + g*VEC + j feeds MMA row g
//    of tile j, column c0 + (8+g)*VEC + j row g+8. No shuffles, no shared
//    staging of codes.
//  * Dequantisation: a 256-entry table byte -> bf16x2 {cb[b&15], cb[b>>4]}
//    (bits=4) or byte -> bf16 cb[b] (bits=8), built by the wrapper from the
//    f32 codebook, replicated once per bank in shared memory (lane l reads
//    copy l: no bank conflicts); then one bf16x2 multiply by
//    {s[k_lo, n/block], s[k_hi, n/block]}. Rounding: cb is rounded to bf16
//    in the table and cb*s rounded once more to bf16 (round to nearest)
//    before the product, which is exact in the f32 accumulator.
//  * One launch per call. Blocks of 8 warps take one column tile (16*VEC
//    columns; the wrapper picks VEC) and one K split; each warp takes one
//    k-group (8 pairs) of every 64-pair chunk, the block stages the chunk's
//    x and scales together, and the warps sum their partials through
//    shared memory in warp order. Where the wrapper splits K across blocks
//    to fill the SMs, the splits of a tile are summed in split order inside
//    the launch, so results do not depend on scheduling and two calls are
//    bitwise equal: each block writes its f32 partial to a wrapper-owned
//    workspace, and the last block of the tile to arrive (a counter it
//    resets to 0) sums the partials.
//  * Latency. A chunk's code loads and its x and scale loads land in a
//    ring of D register sets (2 to 4, as registers allow) D - 1 chunks
//    ahead of the compute; the staging goes through two shared buffers, so
//    one barrier a chunk suffices. The first chunks' loads are issued
//    before the table is filled.
//
// 2. dequant_matmul_kernel, f32 activations: the CUDA-core kernel of the
//    first port (no served config runs it). One block per (128 columns, M
//    tile <= 16 rows, lead index, K split); each lane owns 4 adjacent
//    columns (one 32-bit code load), the 8 warps take interleaved code rows
//    of each 128-row chunk, the codebook and the chunk's activations sit in
//    shared memory as f32, and K splits write f32 partials that a second
//    kernel sums in a fixed order.
//
// Both decode bits=4 codes with the per-tile half interleave of
// core/nibble.py (the wrapper passes `tile`) and mask the ragged edges (M
// rows, N columns, K pairs); nothing is padded.

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


// ---------------------------------------------------------------------------
// bf16 activations: tensor cores (see the note at the top of the file)

namespace mma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTable = 256 * 32;  // words: 256 entries x one copy per bank

struct Args {
  const uint16_t* x;       // bf16 (E, M, K)
  const uint8_t* codes;    // (E, K/2 or K, N)
  const uint16_t* scales;  // bf16 (E, K, N/block)
  const uint32_t* table;   // 256 words: byte -> bf16x2 (bits=4) or bf16
  uint16_t* out;           // bf16 (E, M, N)
  float* ws;               // f32 partials, splits * tiles * MT * CW
  int* counters;           // one per (lead, M tile, column tile), all 0
  int E, M, K, N, block, tile, splits;
};

template <int BITS, int NT, int VEC>
struct Shape {
  static constexpr int MT = 8 * NT;                // tokens per block
  static constexpr int CW = 16 * VEC;              // columns per block
  static constexpr int CH = kWarps * 8;            // k-pairs per chunk:
                                                   // one k-group a warp
  static constexpr int XS = MT == 8 ? 8 : MT + 8;  // xs row stride (words):
                                                   // B-fragment reads hit
                                                   // 32 distinct banks
  static constexpr int NBS = CW / 32;              // scale blocks staged
  static constexpr int W = VEC / 4;                // words per code load
  static constexpr int LOADS = BITS == 4 ? 4 : 8;  // code loads a chunk
  static constexpr int XE = MT * CH / kThreads;    // x pairs staged/thread
  static constexpr int SE = (CH * NBS + kThreads - 1) / kThreads;  // scales
  // Chunks in the register ring (D - 1 in flight while one is computed):
  // as deep as 96 registers of accumulators and ring allow, 2 to 4.
  static constexpr int ACC = 4 * VEC * NT;
  static constexpr int SET = LOADS * W + 2 * (XE + SE);
  static constexpr int D_FIT = (96 - ACC) / SET;
  static constexpr int D = D_FIT < 2 ? 2 : D_FIT > 4 ? 4 : D_FIT;
  static constexpr int RW = CW * (MT + 1);         // reduction words/warp
  static constexpr int TW = MT * CW;               // words of a partial
  static constexpr int PER = TW / kThreads;        // of them per thread
  static constexpr int kStage = CH * XS + CH * NBS;  // words of one buffer
  static constexpr size_t kLoopBytes = 4 * (kTable + 2 * kStage);
  static constexpr size_t kRedBytes = 4 * (size_t)kWarps * RW;
  static constexpr size_t kSmem =
      kLoopBytes > kRedBytes ? kLoopBytes : kRedBytes;
};

// {lo, hi} * {s_lo, s_hi}, each rounded to nearest bf16 (a*b + -0 is a*b).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One VEC-byte load of adjacent code bytes (zeros where masked).
template <int W>
__device__ __forceinline__ void load_codes(uint32_t (&w)[W],
                                           const uint8_t* p, bool ok) {
  if constexpr (W == 2) {
    uint2 v = make_uint2(0u, 0u);
    if (ok) v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
  }
}

// The two k of pair p: nibble halves of one byte row (bits=4), or byte
// rows 2p and 2p+1 (bits=8).
template <int BITS>
__device__ __forceinline__ void pair_k(int p, int half, int& k_lo,
                                       int& k_hi) {
  if constexpr (BITS == 4) {
    k_lo = p + (p / half) * half;
    k_hi = k_lo + half;
  } else {
    k_lo = 2 * p;
    k_hi = 2 * p + 1;
  }
}

// One thread's share of a chunk's x pairs and scale pairs, as raw bf16
// halves (0 where masked), loaded a few chunks ahead of their staging.
template <int XE, int SE>
struct Stage {
  uint16_t xl[XE], xh[XE], sl[SE], sh[SE];
};

// One thread's view of a block: where its code loads, staging entries and
// fragments lie.
template <int BITS, int NT, int VEC>
struct Block {
  using S = Shape<BITS, NT, VEC>;
  using Codes = uint32_t[S::LOADS][S::W];
  using St = Stage<S::XE, S::SE>;
  const uint16_t* xe;  // x of this lead index
  const uint8_t* ce;   // codes of this lead index
  const uint16_t* se;  // scales of this lead index
  int M, K, N, P, half, n_blk, nb0, m0;
  int tid, warp, lane, g, t;
  int c_lo, c_hi, j_lo, j_hi;  // this lane's two column chunks
  bool lo_ok, hi_ok;

  // bits=4: code[2h + side] is pair t + 4h of the warp's k-group, side 0 =
  // columns c_lo (MMA row g), 1 = c_hi (row g+8): A register 2h + side.
  // bits=8: code[4h + 2*side + r] is byte row 2p + r of that pair.
  __device__ __forceinline__ void load_chunk_codes(int c,
                                                   Codes& code) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = c * S::CH + warp * 8 + t + 4 * h;
      const bool p_ok = p < P;
      if constexpr (BITS == 4) {
        const uint8_t* row = ce + (size_t)p * N;
        load_codes(code[2 * h], row + c_lo, p_ok && lo_ok);
        load_codes(code[2 * h + 1], row + c_hi, p_ok && hi_ok);
      } else {
        const bool r1_ok = p_ok && 2 * p + 1 < K;
        const uint8_t* r0 = ce + (size_t)(2 * p) * N;
        const uint8_t* r1 = r0 + N;
        load_codes(code[4 * h], r0 + c_lo, p_ok && lo_ok);
        load_codes(code[4 * h + 1], r1 + c_lo, r1_ok && lo_ok);
        load_codes(code[4 * h + 2], r0 + c_hi, p_ok && hi_ok);
        load_codes(code[4 * h + 3], r1 + c_hi, r1_ok && hi_ok);
      }
    }
  }

  // x entry i: token i / CH, pair i % CH; scale entry i: pair i / NBS,
  // block nb0 + i % NBS.
  __device__ __forceinline__ void load_chunk_stage(int c, St& st) const {
#pragma unroll
    for (int u = 0; u < S::XE; ++u) {
      const int i = tid + u * kThreads;
      const int m = i / S::CH, p = c * S::CH + i % S::CH;
      st.xl[u] = st.xh[u] = 0;
      if (m0 + m < M && p < P) {
        int k_lo, k_hi;
        pair_k<BITS>(p, half, k_lo, k_hi);
        const uint16_t* row = xe + (size_t)(m0 + m) * K;
        st.xl[u] = row[k_lo];
        if (k_hi < K) st.xh[u] = row[k_hi];
      }
    }
#pragma unroll
    for (int u = 0; u < S::SE; ++u) {
      const int i = tid + u * kThreads;
      const int p = c * S::CH + i / S::NBS, nb = nb0 + i % S::NBS;
      st.sl[u] = st.sh[u] = 0;
      if (i < S::CH * S::NBS && p < P && nb < n_blk) {
        int k_lo, k_hi;
        pair_k<BITS>(p, half, k_lo, k_hi);
        st.sl[u] = se[(size_t)k_lo * n_blk + nb];
        if (k_hi < K) st.sh[u] = se[(size_t)k_hi * n_blk + nb];
      }
    }
  }

  __device__ __forceinline__ void store_stage(const St& st, uint32_t* xs,
                                              uint32_t* ss) const {
#pragma unroll
    for (int u = 0; u < S::XE; ++u) {
      const int i = tid + u * kThreads;
      xs[(i % S::CH) * S::XS + i / S::CH] =
          (uint32_t)st.xl[u] | ((uint32_t)st.xh[u] << 16);
    }
#pragma unroll
    for (int u = 0; u < S::SE; ++u) {
      const int i = tid + u * kThreads;
      if (i < S::CH * S::NBS)
        ss[i] = (uint32_t)st.sl[u] | ((uint32_t)st.sh[u] << 16);
    }
  }

  // The warp's k-group of one chunk: VEC tiles of 16 columns x 16 k, each
  // dequantised once and multiplied with NT n8-tiles of tokens.
  __device__ __forceinline__ void compute(const Codes& code,
                                          const uint32_t* xs,
                                          const uint32_t* ss,
                                          const uint32_t* tbl,
                                          float (&acc)[VEC][NT][4]) const {
    const int pl = warp * 8 + t;
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      b[nt][0] = xs[pl * S::XS + nt * 8 + g];
      b[nt][1] = xs[(pl + 4) * S::XS + nt * 8 + g];
    }
    const uint32_t s[4] = {ss[pl * S::NBS + j_lo], ss[pl * S::NBS + j_hi],
                           ss[(pl + 4) * S::NBS + j_lo],
                           ss[(pl + 4) * S::NBS + j_hi]};
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (BITS == 4) {
          const uint32_t byte = (code[r][j >> 2] >> (8 * (j & 3))) & 0xFFu;
          w[r] = tbl[byte * 32 + lane];
        } else {
          const uint32_t b0 = (code[2 * r][j >> 2] >> (8 * (j & 3))) & 0xFFu;
          const uint32_t b1 =
              (code[2 * r + 1][j >> 2] >> (8 * (j & 3))) & 0xFFu;
          w[r] = __byte_perm(tbl[b0 * 32 + lane], tbl[b1 * 32 + lane],
                             0x5410);
        }
        w[r] = mul_bf16x2(w[r], s[r]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_16816(acc[j][nt], w[0], w[1], w[2], w[3], b[nt][0], b[nt][1]);
    }
  }
};

__device__ __forceinline__ void store_bf16(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16(v));
}

template <int BITS, int NT, int VEC>
__global__ void __launch_bounds__(kThreads, 2) kernel(Args a) {
  using S = Shape<BITS, NT, VEC>;
  constexpr int D = S::D;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tbl = smem;                         // [256][32]
  uint32_t* stage = smem + kTable;              // 2 x ([CH][XS], [CH][NBS])
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][RW], at the end
  __shared__ int last_block;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int ct = blockIdx.x, my = blockIdx.y;
  const int e = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const int col0 = ct * S::CW, m0 = my * S::MT;
  const int n_blk = a.N / a.block, nb0 = col0 / a.block;
  const int P = BITS == 4 ? a.K / 2 : (a.K + 1) / 2;  // k-pairs
  const int code_rows = BITS == 4 ? a.K / 2 : a.K;
  Block<BITS, NT, VEC> B;
  B.xe = a.x + (size_t)e * a.M * a.K;
  B.ce = a.codes + (size_t)e * code_rows * a.N;
  B.se = a.scales + (size_t)e * a.K * n_blk;
  B.M = a.M, B.K = a.K, B.N = a.N, B.P = P;
  B.half = BITS == 4 ? a.tile / 2 : 1;
  B.n_blk = n_blk, B.nb0 = nb0, B.m0 = m0;
  B.tid = tid, B.warp = warp, B.lane = lane, B.g = g, B.t = t;
  // this lane's VEC columns for MMA row g and row g+8 of every tile
  B.c_lo = col0 + g * VEC, B.c_hi = col0 + (8 + g) * VEC;
  B.lo_ok = B.c_lo < a.N, B.hi_ok = B.c_hi < a.N;
  B.j_lo = B.lo_ok ? B.c_lo / a.block - nb0 : 0;
  B.j_hi = B.hi_ok ? B.c_hi / a.block - nb0 : 0;

  const int n_chunks = (P + S::CH - 1) / S::CH;
  const int c_begin = (int)((long long)n_chunks * split / a.splits);
  const int c_end = (int)((long long)n_chunks * (split + 1) / a.splits);

  // The ring: chunk c_begin + r lives in set r % D. The first D - 1 chunks'
  // loads are issued before the table is filled.
  typename Block<BITS, NT, VEC>::Codes code[D];
  typename Block<BITS, NT, VEC>::St st[D];
#pragma unroll
  for (int i = 0; i < D - 1; ++i)
    if (c_begin + i < c_end) {
      B.load_chunk_codes(c_begin + i, code[i]);
      B.load_chunk_stage(c_begin + i, st[i]);
    }
  {  // the table, entry b of copy l at word b*32 + l (rotated stores)
    const uint32_t v = __ldg(a.table + tid);
#pragma unroll
    for (int l = 0; l < 32; ++l) tbl[tid * 32 + ((l + lane) & 31)] = v;
  }

  float acc[VEC][NT][4];
#pragma unroll
  for (int j = 0; j < VEC; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][nt][q] = 0.f;

#pragma unroll 1
  for (int c0 = c_begin; c0 < c_end; c0 += D) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const int c = c0 + i;
      if (c < c_end) {  // uniform over the block
        uint32_t* xs = stage + (c & 1) * S::kStage;
        uint32_t* ss = xs + S::CH * S::XS;
        // buffer c & 1 was last read in chunk c - 2, before the barrier of
        // chunk c - 1
        B.store_stage(st[i], xs, ss);
        __syncthreads();
        // set (i + D - 1) % D held chunk c - 1, computed in the last step
        if (c + D - 1 < c_end) {
          B.load_chunk_codes(c + D - 1, code[(i + D - 1) % D]);
          B.load_chunk_stage(c + D - 1, st[(i + D - 1) % D]);
        }
        B.compute(code[i], xs, ss, tbl, acc);
      }
    }
  }

  // Sum the warps' partials in warp order. Accumulator q of tile j, n-tile
  // nt is (MMA row g + 8*(q>>1), token 2t + (q&1)).
  __syncthreads();  // red overlays the table and the staging
  float* rw = red + warp * S::RW;
#pragma unroll
  for (int j = 0; j < VEC; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = ((q >> 1) * 8 + g) * VEC + j;
        const int m = nt * 8 + 2 * t + (q & 1);
        rw[n * (S::MT + 1) + m] = acc[j][nt][q];
      }
  __syncthreads();
  // element i = tid + u * kThreads of the block's partial: token i / CW,
  // column i % CW
  float sums[S::PER];
#pragma unroll
  for (int u = 0; u < S::PER; ++u) {
    const int i = tid + u * kThreads;
    const int m = i / S::CW, n = i % S::CW;
    sums[u] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sums[u] += red[w * S::RW + n * (S::MT + 1) + m];
  }
  uint16_t* ye = a.out + (size_t)e * a.M * a.N;
  if (a.splits == 1) {
#pragma unroll
    for (int u = 0; u < S::PER; ++u) {
      const int i = tid + u * kThreads;
      const int m = i / S::CW, n = i % S::CW;
      if (m0 + m < a.M && col0 + n < a.N)
        store_bf16(ye + (size_t)(m0 + m) * a.N + col0 + n, sums[u]);
    }
    return;
  }

  // Each block writes its partial to the workspace, and the last block of
  // this tile to arrive sums the partials in split order (loads issued 8
  // splits at a time, added in order).
  const int tile_id = (e * gridDim.y + my) * gridDim.x + ct;
  float* part = a.ws + ((size_t)tile_id * a.splits + split) * S::TW;
#pragma unroll
  for (int u = 0; u < S::PER; ++u) part[tid + u * kThreads] = sums[u];
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_block = atomicAdd(a.counters + tile_id, 1) == a.splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const float* parts = a.ws + (size_t)tile_id * a.splits * S::TW;
#pragma unroll
  for (int u = 0; u < S::PER; ++u) {
    const int i = tid + u * kThreads;
    const int m = i / S::CW, n = i % S::CW;
    if (m0 + m >= a.M || col0 + n >= a.N) continue;
    float sum = 0.f;
    for (int s0 = 0; s0 < a.splits; s0 += 8) {
      float v[8];
#pragma unroll
      for (int s = 0; s < 8; ++s)
        v[s] = s0 + s < a.splits ? __ldcg(parts + (s0 + s) * S::TW + i)
                                 : 0.f;
#pragma unroll
      for (int s = 0; s < 8; ++s)
        if (s0 + s < a.splits) sum += v[s];
    }
    store_bf16(ye + (size_t)(m0 + m) * a.N + col0 + n, sum);
  }
  if (tid == 0) a.counters[tile_id] = 0;
}

template <int BITS, int NT, int VEC>
int launch(const Args& a, cudaStream_t stream) {
  using S = Shape<BITS, NT, VEC>;
  static unsigned configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel<BITS, NT, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const dim3 grid((a.N + S::CW - 1) / S::CW, (a.M + S::MT - 1) / S::MT,
                  a.E * a.splits);
  kernel<BITS, NT, VEC><<<grid, kThreads, S::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// NT = ceil(M / 8) n8-tiles (at most 4) and VEC bytes per code load: 8 up
// to 8 tokens, else 4 (at most 64 accumulators a lane).
template <int BITS>
int dispatch(int nt, int vec, const Args& a, cudaStream_t s) {
  if (nt == 1 && vec == 8) return launch<BITS, 1, 8>(a, s);
  if (nt == 1 && vec == 4) return launch<BITS, 1, 4>(a, s);
  if (nt == 2 && vec == 4) return launch<BITS, 2, 4>(a, s);
  if (nt == 4 && vec == 4) return launch<BITS, 4, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}

// Registers, dynamic shared memory, resident blocks per SM, local (spill)
// bytes and ring depth of one instance, into out[0..4].
template <int BITS, int NT, int VEC>
int info(int* out) {
  using S = Shape<BITS, NT, VEC>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      kernel<BITS, NT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, kernel<BITS, NT, VEC>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel<BITS, NT, VEC>, kThreads, S::kSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)S::kSmem;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  out[4] = S::D;
  return 0;
}

template <int BITS>
int dispatch_info(int nt, int vec, int* out) {
  if (nt == 1 && vec == 8) return info<BITS, 1, 8>(out);
  if (nt == 1 && vec == 4) return info<BITS, 1, 4>(out);
  if (nt == 2 && vec == 4) return info<BITS, 2, 4>(out);
  if (nt == 4 && vec == 4) return info<BITS, 4, 4>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma

}  // namespace

// Launch on `stream`. x (E, M, K), codes (E, K/2 or K, N) uint8, scales
// (E, K, N/block) bf16, out (E, M, N) in x's dtype.
//
// bf16 x: the tensor-core kernel. `table` holds 256 words (byte -> bf16x2
// {cb[b&15], cb[b>>4]} at bits=4, bf16 cb[b] at bits=8); `vec` (4, or 8
// up to 8 tokens; dividing the codes' alignment) is the column width of
// one code load. With splits > 1, `workspace` holds splits * E *
// ceil(M/MT) * ceil(N/(16*vec)) * MT * 16*vec f32 (MT = 8 * ceil(M/8), at
// most 32) and `counters` one int per (lead, M tile, column tile), all 0,
// which the kernel leaves at 0. Calls that share a workspace must be
// ordered (one stream).
//
// f32 x: the CUDA-core kernel; `codebook` (n_codes,) f32, and with
// splits > 1 `workspace` holds splits*E*M*N f32; table, counters and vec
// are not read.
//
// Returns the cudaError_t of the launches (0 on success).
extern "C" int dequant_matmul_launch(
    const void* x, const void* codes, const void* scales,
    const void* codebook, const void* table, void* out, void* workspace,
    void* counters, int x_is_bf16, int E, int M, int K, int N, int block,
    int bits, int tile, int n_codes, int vec, int splits, void* stream) {
  if (E < 1 || M < 1 || K < 1 || N < 1 || block < 4 || N % block != 0 ||
      (bits != 4 && bits != 8) || n_codes < 1 || n_codes > 256 ||
      splits < 1 || (bits == 4 && (tile < 2 || tile % 2 || K % tile)) ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    const int nt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
    if (table == nullptr || (vec != 4 && vec != 8) ||
        block % vec != 0 || (splits > 1 && counters == nullptr))
      return (int)cudaErrorInvalidValue;
    const mma::Args a{static_cast<const uint16_t*>(x),
                      static_cast<const uint8_t*>(codes),
                      static_cast<const uint16_t*>(scales),
                      static_cast<const uint32_t*>(table),
                      static_cast<uint16_t*>(out),
                      static_cast<float*>(workspace),
                      static_cast<int*>(counters),
                      E, M, K, N, block, tile, splits};
    return bits == 4 ? mma::dispatch<4>(nt, vec, a, s)
                     : mma::dispatch<8>(nt, vec, a, s);
  }
  const Geometry g{E, M, K, N, block, tile, n_codes, splits};
  int mt = 1;  // M-tile height: 1, 2, 4, 8 or 16
  while (mt < M && mt < 16) mt *= 2;
  dispatch_bits<float>(bits, mt, x, codes, scales, codebook, out, workspace,
                       g, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t count = (size_t)E * M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  sum_splits_kernel<float><<<blocks, threads, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<float*>(out), splits,
      count);
  return (int)cudaGetLastError();
}

// The tensor-core instance for `bits`, `nt` n8-tiles and `vec`-byte loads:
// out[0..4] = registers per thread, dynamic shared bytes per block, blocks
// resident per SM, local (spill) bytes per thread, chunks in the ring.
extern "C" int dequant_matmul_mma_info(int bits, int nt, int vec, int* out) {
  if (bits == 4) return mma::dispatch_info<4>(nt, vec, out);
  if (bits == 8) return mma::dispatch_info<8>(nt, vec, out);
  return (int)cudaErrorInvalidValue;
}
