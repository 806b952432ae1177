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
// bandwidth bounds it (gemma3-1b's 4-bit table: 162.5 MB at M = 4, 0.0485
// ms at 3.35 TB/s). Two kernels live here:
//
// 1. tc::kernel, bf16 activations (every served config). Tensor cores
//    through mma.sync.m16n8k16 (bf16 in, f32 accumulate). Lane l = 4g + t.
//  * The weight is the A operand (16 output rows v x 16 d), the tokens the
//    n8 operand: ceil(M/8) MMAs per A fragment (at most 4); token rows past
//    M read zeros from shared memory and are never stored. M above 32 runs
//    as further blocks along grid.y.
//  * One warp owns a tile of 16 byte rows j0 .. j0+15 and walks all of D
//    (no K split: no workspace, no combine, and two calls are bitwise
//    equal). At bits=4 the byte rows are nibble-packed along V in the
//    per-tile half interleave of core/nibble.py: byte row j holds v_lo =
//    (j / half) * tile + j % half in its low nibble and v_hi = v_lo + half
//    in its high nibble. MMA tile i (0, 1) takes byte rows j0 + 8i + g: its
//    row g is v_lo, its row g+8 is v_hi, so one byte row feeds both halves
//    of a fragment and each C row writes 16 contiguous v. At bits=8 the
//    warp's 16 byte rows are one MMA tile: row g is byte row j0+g, row g+8
//    byte row j0+8+g.
//  * D is walked in chunks of 64. Lane (g, t) loads the 16 bytes d = 64c +
//    16t .. 64c + 16t + 15 of each of its two byte rows (j0+g, j0+8+g) with
//    one 16-byte load (8- or 4-byte loads where D or the codes' alignment
//    rule 16 out; zeros past D). The order of d inside the dot product is
//    free: in k16 step s (0..3) the lane's k slots 2t, 2t+1 are d = 64c +
//    16t + 4s + {0, 1} and 2t+8, 2t+9 are + {2, 3}. So its B fragments
//    b0, b1 are the four contiguous bf16 x[m = g][64c + 16t + 4s ...]: one
//    8-byte shared load, with x staged in its natural order (row stride D
//    rounded up to 64, plus 4, so the 8 rows' loads fall in distinct
//    banks). The staging holds zeros past D and past M.
//  * Dequantisation: a 256-entry table byte -> bf16x2 {cb[b&15], cb[b>>4]}
//    (bits=4) or byte -> bf16 cb[b] (bits=8), built by the wrapper from the
//    f32 codebook, replicated once per bank in shared memory (lane l reads
//    copy l: no bank conflicts). Two code bytes b0 (d), b1 (d+1) of one
//    byte row give T[b0], T[b1]; prmt(T[b0], T[b1], 0x5410) is row g's
//    bf16x2 k-pair (low nibbles) and prmt(..., 0x7632) row g+8's (high
//    nibbles). At bits=8 one prmt joins the low halves of two bytes of one
//    row. One table read and one prmt per code byte.
//  * The scale varies along the contraction, once per (v, D block): each A
//    register is multiplied by {s, s} of its row and block (fma.rn.bf16x2).
//    cb is rounded to bf16 in the table and cb*s once more to bf16 (round
//    to nearest) before the product, which is exact in the f32
//    accumulator: the rounding of the tensor-core dequant_matmul. Any block
//    that divides D and is a multiple of 4 works: where block % 16 == 0 a
//    lane's 16 bytes share one scale a row, loaded with the chunk's codes;
//    otherwise each k16 step loads its own.
//  * Latency. A chunk's code and scale loads land in a ring of kRing = 2
//    register sets, one chunk ahead of the compute. Blocks of 8 warps, two
//    resident per SM (at most 128 registers a thread), walk the warp tiles
//    grid-stride, so each SM keeps 16 warps x 32 lanes x 32 bytes of code
//    loads in flight: 16 KB, against the ~25 KB that 3.35 TB/s times ~1 us
//    of loaded latency asks of each of 132 SMs. Rings of 3 and 4 sets (32
//    and 48 KB) measured slower on the H100 at every served shape
//    (PERF.md): the loads issued while a chunk is waited on already cover
//    the latency. Code loads are streaming (ld.global.cs: the table is read
//    once); the table fill and the x staging happen once per block, after
//    the first tile's loads are issued.
//  * Output: C fragments go to device memory in x's dtype, rounded to
//    nearest from f32; each store instruction of a warp writes 16
//    contiguous bytes in 4 token rows.
//
// 2. dequant_matmul_t_kernel, CUDA cores: f32 activations, and bf16 ones
//    whose x rows do not fit the tensor-core kernel's shared memory (D
//    above about 12k; no served config runs it). One warp a byte row,
//    lanes stride D 4 code bytes at a time, the D-block scale folded into
//    each lane's partial sum of 4 elements, a shuffle reduction finishes
//    the row; a block stages MT rows of x as f32 and walks byte rows
//    grid-stride.

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



// ---------------------------------------------------------------------------
// bf16 activations: tensor cores (see the note at the top of the file)

namespace tc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTable = 256 * 32;  // words: 256 entries x one copy per bank
constexpr int kTileRows = 16;     // byte rows a warp tile
constexpr int kChunk = 64;        // d a chunk: 16 bytes a lane
constexpr int kStageUnroll = 8;   // x pieces a thread loads before storing
constexpr int kRing = 2;          // chunks of code loads in registers

struct Args {
  const uint16_t* x;       // bf16 (M, D)
  const uint8_t* codes;    // (V/2 or V, D)
  const uint16_t* scales;  // bf16 (V, D/block)
  const uint32_t* table;   // 256 words: byte -> bf16x2 (bits=4) or bf16
  uint16_t* out;           // bf16 (M, V)
  int M, D, V, block, tile, vec;
};

// Row stride of the staged x (bf16): D rounded up to whole chunks, plus 4,
// so that the B-fragment loads of rows g = 0..3 start 2 banks apart.
__host__ __device__ __forceinline__ int x_stride(int D) {
  return (D + kChunk - 1) / kChunk * kChunk + 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int nt, int D) {
  return 4 * (size_t)kTable + 2 * (size_t)(8 * nt) * x_stride(D);
}

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

// The 16 code bytes at p (d0 = the first one's d) in vec-byte loads (16, 8
// or 4; vec divides D and the codes' alignment), zeros past D.
__device__ __forceinline__ uint4 load16(const uint8_t* p, int d0, int D,
                                        int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec == 16) {
    if (d0 < D) v = __ldcs(reinterpret_cast<const uint4*>(p));
  } else if (vec == 8) {
    if (d0 < D) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
      v.x = u.x, v.y = u.y;
    }
    if (d0 + 8 < D) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p + 8));
      v.z = u.x, v.w = u.y;
    }
  } else {
    const unsigned int* q = reinterpret_cast<const unsigned int*>(p);
    if (d0 < D) v.x = __ldcs(q);
    if (d0 + 4 < D) v.y = __ldcs(q + 1);
    if (d0 + 8 < D) v.z = __ldcs(q + 2);
    if (d0 + 12 < D) v.w = __ldcs(q + 3);
  }
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// Table entry of byte q (0..3) of w, from this lane's copy.
__device__ __forceinline__ uint32_t entry(const uint32_t* tbl_l, uint32_t w,
                                          int q) {
  return tbl_l[((w >> (8 * q)) & 0xFFu) * 32];
}

// {h, h} from a bf16 in the low half.
__device__ __forceinline__ uint32_t dup(uint32_t h) {
  return __byte_perm(h, 0u, 0x1010);
}

// One lane's view of one warp tile: its two byte rows j0+g and j0+8+g and
// their output and scale rows. bits=4: rows (v_lo, v_hi) of byte row 0,
// then of byte row 1 (MMA rows g, g+8 of tile 0, then of tile 1); bits=8:
// byte rows 0 and 1 (MMA rows g and g+8 of the one tile). Rows past V are
// read from row 0 and never stored.
template <int BITS>
struct Lane {
  static constexpr int R = BITS == 4 ? 4 : 2;  // output rows
  const uint8_t* crow[2];
  const uint16_t* srow[R];
  int v[R];
  bool ok[2];

  __device__ __forceinline__ void setup(const Args& a, int wt, int g,
                                        int n_sb, int byte_rows) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = wt * kTileRows + 8 * i + g;
      ok[i] = j < byte_rows;
      const int r = ok[i] ? j : 0;
      crow[i] = a.codes + (size_t)r * a.D;
      if constexpr (BITS == 4) {
        const int half = a.tile / 2;
        v[2 * i] = (r / half) * a.tile + r % half;
        v[2 * i + 1] = v[2 * i] + half;
      } else {
        v[i] = r;
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) srow[k] = a.scales + (size_t)v[k] * n_sb;
  }
};

// One chunk in the ring: 16 code bytes of each byte row and, where block %
// 16 == 0, the scale of each output row.
template <int BITS, bool BLK16>
struct Chunk {
  uint4 code[2];
  uint32_t s[BLK16 ? Lane<BITS>::R : 1];
};

template <int BITS, bool BLK16>
__device__ __forceinline__ void load_chunk(const Args& a, const Lane<BITS>& L,
                                           int c, int t, int n_sb,
                                           Chunk<BITS, BLK16>& ch) {
  const int d0 = c * kChunk + 16 * t;
  ch.code[0] = load16(L.crow[0] + d0, d0, a.D, a.vec);
  ch.code[1] = load16(L.crow[1] + d0, d0, a.D, a.vec);
  if constexpr (BLK16) {
    // past D (the ragged chunk) any block does: x is 0 there
    const int sb = min(d0 / a.block, n_sb - 1);
#pragma unroll
    for (int k = 0; k < Lane<BITS>::R; ++k) ch.s[k] = __ldg(L.srow[k] + sb);
  }
}

// Chunk c's 4 k16 steps: dequantise the A fragments and multiply them with
// every n8-tile of tokens. xc = this lane's staged x at token g, d = 64c +
// 16t.
template <int BITS, int NT, bool BLK16>
__device__ __forceinline__ void compute(
    const Args& a, const Lane<BITS>& L, const Chunk<BITS, BLK16>& ch,
    int c, int t, int n_sb, const uint16_t* xc, int xs_stride,
    const uint32_t* tbl_l, float (&acc)[BITS == 4 ? 2 : 1][NT][4]) {
  constexpr int R = Lane<BITS>::R;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 bx = *reinterpret_cast<const uint2*>(
          xc + nt * 8 * xs_stride + 4 * s);
      b[nt][0] = bx.x, b[nt][1] = bx.y;
    }
    uint32_t sc[R];
    if constexpr (BLK16) {
#pragma unroll
      for (int k = 0; k < R; ++k) sc[k] = dup(ch.s[k]);
    } else {
      const int sb = min((c * kChunk + 16 * t + 4 * s) / a.block, n_sb - 1);
#pragma unroll
      for (int k = 0; k < R; ++k) sc[k] = dup(__ldg(L.srow[k] + sb));
    }
    if constexpr (BITS == 4) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t w = word(ch.code[i], s);
        const uint32_t e0 = entry(tbl_l, w, 0), e1 = entry(tbl_l, w, 1);
        const uint32_t e2 = entry(tbl_l, w, 2), e3 = entry(tbl_l, w, 3);
        const uint32_t a0 = mul_bf16x2(__byte_perm(e0, e1, 0x5410), sc[2 * i]);
        const uint32_t a1 =
            mul_bf16x2(__byte_perm(e0, e1, 0x7632), sc[2 * i + 1]);
        const uint32_t a2 = mul_bf16x2(__byte_perm(e2, e3, 0x5410), sc[2 * i]);
        const uint32_t a3 =
            mul_bf16x2(__byte_perm(e2, e3, 0x7632), sc[2 * i + 1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[i][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
      }
    } else {
      const uint32_t w0 = word(ch.code[0], s), w1 = word(ch.code[1], s);
      const uint32_t a0 = mul_bf16x2(
          __byte_perm(entry(tbl_l, w0, 0), entry(tbl_l, w0, 1), 0x5410),
          sc[0]);
      const uint32_t a2 = mul_bf16x2(
          __byte_perm(entry(tbl_l, w0, 2), entry(tbl_l, w0, 3), 0x5410),
          sc[0]);
      const uint32_t a1 = mul_bf16x2(
          __byte_perm(entry(tbl_l, w1, 0), entry(tbl_l, w1, 1), 0x5410),
          sc[1]);
      const uint32_t a3 = mul_bf16x2(
          __byte_perm(entry(tbl_l, w1, 2), entry(tbl_l, w1, 3), 0x5410),
          sc[1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_16816(acc[0][nt], a0, a1, a2, a3, b[nt][0], b[nt][1]);
    }
  }
}

template <int BITS, int NT, bool BLK16>
__global__ void __launch_bounds__(kThreads, 2) kernel(Args a) {
  constexpr int MT = 8 * NT;
  constexpr int TILES = BITS == 4 ? 2 : 1;  // MMA row tiles a warp tile
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tbl = smem;                                    // [256][32]
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + kTable);  // [MT][XS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // MMA group and thread in group
  const int m0 = blockIdx.y * MT;
  const int xs_stride = x_stride(a.D);
  const int n_chunks = (a.D + kChunk - 1) / kChunk;
  const int n_sb = a.D / a.block;
  const int byte_rows = BITS == 4 ? a.V / 2 : a.V;
  const int n_tiles = (byte_rows + kTileRows - 1) / kTileRows;
  const int wt_step = gridDim.x * kWarps;

  // The ring: chunk r of the current tile lives in set r % kRing. The
  // first tile's first kRing - 1 chunks are loaded before the staging.
  int wt = blockIdx.x * kWarps + warp;
  Lane<BITS> L;
  Chunk<BITS, BLK16> ring[kRing];
  if (wt < n_tiles) {
    L.setup(a, wt, g, n_sb, byte_rows);
#pragma unroll
    for (int i = 0; i < kRing - 1; ++i)
      if (i < n_chunks) load_chunk(a, L, i, t, n_sb, ring[i]);
  }

  {  // the table, entry b of copy l at word b*32 + l (rotated stores)
    const uint32_t v = __ldg(a.table + tid);
#pragma unroll
    for (int l = 0; l < 32; ++l) tbl[tid * 32 + ((l + lane) & 31)] = v;
  }
  {  // x rows m0 .. m0+MT-1 in 4-bf16 pieces, zeros past M and D
    const int per_row = xs_stride / 4;
    const int n = MT * per_row;
    const bool x8 = (reinterpret_cast<uintptr_t>(a.x) & 7) == 0;
    for (int i0 = 0; i0 < n; i0 += kThreads * kStageUnroll) {
      uint2 piece[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = i0 + u * kThreads + tid;
        const int m = i / per_row, d = (i % per_row) * 4;
        piece[u] = make_uint2(0u, 0u);
        if (i < n && m0 + m < a.M && d < a.D) {
          const uint16_t* src = a.x + (size_t)(m0 + m) * a.D + d;
          if (x8) {
            piece[u] = *reinterpret_cast<const uint2*>(src);
          } else {
            piece[u].x = (uint32_t)src[0] | ((uint32_t)src[1] << 16);
            piece[u].y = (uint32_t)src[2] | ((uint32_t)src[3] << 16);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < n)
          *reinterpret_cast<uint2*>(xs + (i / per_row) * xs_stride +
                                    (i % per_row) * 4) = piece[u];
      }
    }
  }
  __syncthreads();

  const uint32_t* tbl_l = tbl + lane;
  const uint16_t* xs_l = xs + g * xs_stride + 16 * t;
  while (wt < n_tiles) {  // uniform over the warp
    float acc[TILES][NT][4];
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][nt][q] = 0.f;

#pragma unroll 1
    for (int c0 = 0; c0 < n_chunks; c0 += kRing) {
#pragma unroll
      for (int i = 0; i < kRing; ++i) {
        const int c = c0 + i;
        if (c < n_chunks) {
          // set (i + kRing - 1) % kRing held chunk c - 1, computed last step
          if (c + kRing - 1 < n_chunks)
            load_chunk(a, L, c + kRing - 1, t, n_sb,
                       ring[(i + kRing - 1) % kRing]);
          compute<BITS, NT, BLK16>(a, L, ring[i], c, t, n_sb,
                                   xs_l + c * kChunk, xs_stride, tbl_l, acc);
        }
      }
    }

    // Accumulator q of tile i, n-tile nt: MMA row g + 8*(q>>1), token
    // m0 + 8*nt + 2t + (q&1).
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = BITS == 4 ? 2 * i + h : h;  // output row of MMA row
        if (!L.ok[BITS == 4 ? i : h]) continue;   // g + 8h
        uint16_t* col = a.out + L.v[k];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int m = m0 + nt * 8 + 2 * t + e;
            if (m < a.M)
              col[(size_t)m * a.V] =
                  __bfloat16_as_ushort(__float2bfloat16(acc[i][nt][2 * h + e]));
          }
      }
    }

    wt += wt_step;
    if (wt < n_tiles) {
      L.setup(a, wt, g, n_sb, byte_rows);
#pragma unroll
      for (int i = 0; i < kRing - 1; ++i)
        if (i < n_chunks) load_chunk(a, L, i, t, n_sb, ring[i]);
    }
  }
}

// Allow this instance `smem` bytes of dynamic shared memory on the current
// device (raised only, once per size).
template <int BITS, int NT, bool BLK16>
cudaError_t allow_smem(size_t smem) {
  static size_t allowed[32] = {};  // per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (allowed[dev] < smem) {
    err = cudaFuncSetAttribute(kernel<BITS, NT, BLK16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

template <int BITS, int NT, bool BLK16>
int launch(const Args& a, int n_blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(NT, a.D);
  const cudaError_t err = allow_smem<BITS, NT, BLK16>(smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_blocks, (a.M + 8 * NT - 1) / (8 * NT));
  kernel<BITS, NT, BLK16><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of one instance at this D (registers and spills
// are in nvcc's -Xptxas -v report).
template <int BITS, int NT, bool BLK16>
int info(int D, int* blocks) {
  const size_t smem = smem_bytes(NT, D);
  cudaError_t err = allow_smem<BITS, NT, BLK16>(smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel<BITS, NT, BLK16>, kThreads, smem);
  return (int)err;
}

// One instance per (bits, n8-tiles, block % 16 == 0). do_info selects
// info().
template <int BITS, int NT>
int pick(bool blk16, bool do_info, const Args& a, int n_blocks,
         cudaStream_t s, int* out) {
  if (blk16)
    return do_info ? info<BITS, NT, true>(a.D, out)
                   : launch<BITS, NT, true>(a, n_blocks, s);
  return do_info ? info<BITS, NT, false>(a.D, out)
                 : launch<BITS, NT, false>(a, n_blocks, s);
}

template <int BITS>
int pick_nt(int nt, bool blk16, bool do_info, const Args& a, int n_blocks,
            cudaStream_t s, int* out) {
  if (nt == 1) return pick<BITS, 1>(blk16, do_info, a, n_blocks, s, out);
  if (nt == 2) return pick<BITS, 2>(blk16, do_info, a, n_blocks, s, out);
  if (nt == 4) return pick<BITS, 4>(blk16, do_info, a, n_blocks, s, out);
  return (int)cudaErrorInvalidValue;
}

int dispatch(int bits, int nt, bool do_info, const Args& a, int n_blocks,
             cudaStream_t s, int* out) {
  const bool blk16 = a.block % 16 == 0;
  if (bits == 4) return pick_nt<4>(nt, blk16, do_info, a, n_blocks, s, out);
  if (bits == 8) return pick_nt<8>(nt, blk16, do_info, a, n_blocks, s, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// Launch on `stream`. x (M, D) in bf16 or f32, codes (V/2 or V, D) uint8,
// scales (V, D/block) bf16, out (M, V) in x's dtype. tile: the nibble
// interleave tile along V (bits=4).
//
// `table` given: the tensor-core kernel (bf16 x). `table` holds 256 words
// (byte -> bf16x2 {cb[b&15], cb[b>>4]} at bits=4, bf16 cb[b] at bits=8);
// `mt` (8, 16 or 32) is the number of x rows a block stages,
// (256*32*4 + mt*XS*2) bytes of shared memory with XS = D rounded up to
// 64, plus 4; `vec` (16, 8 or 4, dividing D and the codes' alignment) is
// the width of one code load; `n_blocks` blocks of 8 warps walk the tiles
// of 16 byte rows.
//
// `table` null: the CUDA-core kernel; `codebook` (n_codes,) f32; `mt`
// (1..32, a power of two) is the number of x rows a block stages,
// (256 + mt*D)*4 bytes of shared memory; vec is not read.
//
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dequant_matmul_t_launch(const void* x, const void* codes,
                                       const void* scales,
                                       const void* codebook,
                                       const void* table, void* out,
                                       int x_is_bf16, int M, int D, int V,
                                       int block, int bits, int tile,
                                       int n_codes, int mt, int n_blocks,
                                       int vec, void* stream) {
  if (M < 1 || D < 4 || V < 1 || D % 4 || block < 4 || block % 4 ||
      D % block || (bits != 4 && bits != 8) || n_codes < 1 ||
      n_codes > (bits == 4 ? 16 : 256) || n_blocks < 1 ||
      (bits == 4 && (tile < 2 || tile % 2 || V % tile)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table != nullptr) {
    if (!x_is_bf16 || (mt != 8 && mt != 16 && mt != 32) ||
        (vec != 4 && vec != 8 && vec != 16) || D % vec)
      return (int)cudaErrorInvalidValue;
    const tc::Args a{static_cast<const uint16_t*>(x),
                     static_cast<const uint8_t*>(codes),
                     static_cast<const uint16_t*>(scales),
                     static_cast<const uint32_t*>(table),
                     static_cast<uint16_t*>(out),
                     M, D, V, block, bits == 4 ? tile : V, vec};
    return tc::dispatch(bits, mt / 8, false, a, n_blocks, s, nullptr);
  }
  const GeometryT g{M, D, V, block, tile};
  cudaError_t err;
  if (x_is_bf16)
    err = bits == 4 ? dispatch_mt<4, __nv_bfloat16>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s)
                    : dispatch_mt<8, __nv_bfloat16>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
  else
    err = bits == 4 ? dispatch_mt<4, float>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s)
                    : dispatch_mt<8, float>(mt, x, codes, scales, codebook, n_codes, out, g, n_blocks, s);
  return (int)err;
}

// Blocks resident per SM of the tensor-core instance for `bits`, `nt`
// n8-tiles and block (only block % 16 == 0 matters) at contraction length
// D, into *blocks.
extern "C" int dequant_matmul_t_tc_blocks_per_sm(int bits, int nt, int block,
                                                 int D, int* blocks) {
  if (D < 4 || block < 4) return (int)cudaErrorInvalidValue;
  const tc::Args a{nullptr, nullptr, nullptr, nullptr, nullptr,
                   1, D, 1, block, 2, 4};
  return tc::dispatch(bits, nt, true, a, 1, nullptr, blocks);
}
