// Decode attention straight from a block-scaled quantised KV cache, for
// Hopper (sm_90a). For each batch row b, query token t and head h:
//   out[b, t, h] = softmax_s(mask(q[b, t, h] . K[b, s, k] * hd^-0.5)) . V[b, s, k]
// with k = h / G (GQA, G = H / K) and K/V dequantised from uint8 codes:
//   K[b, s, k, d] = codebook[code[b, s, k, d]] * scale[b, s, k]
// (q4: codes nibble-packed pairwise along hd, byte j = element 2j in the low
// nibble and 2j + 1 in the high nibble).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/
// decode_attention.py:decode_attention_quant (body _kernel, _dequant); the
// function it computes is the oracle decode_attention_quant_ref (dequantise,
// then the dense masked chunked decode attention). Masks are built here from
// the query positions alone:
//   linear caches: slot s holds position s; visible when s <= qpos and, with
//                  window > 0, qpos - s < window;
//   ring caches:   slot s holds position kv = last - ((last - s) mod S), last
//                  = qpos[T - 1] of the row; visible when kv <= qpos,
//                  qpos - kv < window and kv >= 0 (written).
// Masked scores are -1e30, not -inf, as in the reference, so a row that sees
// no slot gets the reference's answer, the mean of V. Slots past S take no
// part (weight 0).
//
// Bound. Per call it reads the layer's K and V codes once (2*B*S*K*hdc
// bytes plus 8 bytes of scales per slot) and does 4*B*T*H*S*hd flops. At
// gemma3-1b's shapes (B = 4, K = 1, H = 4, hd = 256, S = 520 or 1032) that
// is 0.3-2 MB, well under a microsecond of the card's bandwidth: a call is
// bound by latency, the launch and each dependent round trip.
//
// Design: one launch a call, every load of a block issued before its first
// use, S split across the blocks of one thread block cluster.
// * A block is (split of S, group), a group is (b, kv head k, tile of query
//   rows). The T*G query rows of a head share every K/V row loaded.
// * Splits: the blocks of a group are one cluster (2 to 16 blocks, as many
//   as the card can co-schedule). Each block leaves its (m, l, acc) partial
//   in its shared memory; after a cluster barrier block r combines items r,
//   r + splits, ... reading every block's partial through distributed shared
//   memory, in split order, with the same formula as one sweep:
//   M = max m, out = sum(acc * exp(m - M)) / max(sum(l * exp(m - M)), 1e-30);
//   a second barrier keeps the partials alive until all are read. Results do
//   not depend on scheduling: reruns are bitwise equal. (A combine through
//   a global workspace and a last-block counter took about 3.4 µs more a
//   call at gemma3-1b's decode shape on an H100: a fence, an atomic and
//   dependent L2 round trips.)
// * The q8 codebook sits in shared memory, one copy per bank (lane l reads
//   copy l: no bank conflicts); q4's 16 entries need no copies.
// * Decode rows (attn_rows_kernel: f32 q, or 8 rows or fewer a kv head, or an
//   hd without a tensor-core instance; tiles of 4 or 8 rows): each warp takes
//   batches of 32 / rows slots; a lane owns hd/32 consecutive elements (8 at
//   hd = 256: one 8-byte q8 or 4-byte q4 load per row, a warp reads a row
//   coalesced) and keeps its slice of every query row, its rows' running max
//   and sum and its accumulator slice in registers (f32). The 32 (row, slot)
//   partial dot products of a batch are summed across the warp by a
//   butterfly that leaves lane l with the whole score of pair l (31
//   shuffles, not 5 per pair), so the softmax costs one exp a lane; the
//   probabilities (times the V scale) go back to every lane by shuffles for
//   P.V. The warps of a block merge through shared memory in warp order.
// * Prefill chunks (attn_mma_kernel: bf16 q, more than 8 rows a kv head, hd
//   64, 128 or 256) on tensor cores, see the note before it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;  // a masked score, as in the reference
constexpr int kMaxHd = 256;
constexpr int kMaxWarps = 8;       // warps per block of attn_rows_kernel
constexpr int kMaxCluster = 16;    // blocks a cluster: the most splits
constexpr int kTable = 256 * 32;   // q8 codebook: 256 entries x one copy a bank
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;          // (B, T, H, hd) bf16 or f32
  const uint8_t* kc;      // (B, S, K, hdc)
  const float* ks;        // (B, S, K)
  const uint8_t* vc;
  const float* vs;
  const float* cb;        // (n_codes,)
  const int* qpos;        // (B, T)
  void* out;              // (B, T, H, hd), q's dtype
  int B, T, H, K, hd, S, n_codes, window, ring;
  int row_tile, row_tiles, warps, splits;
  float scale;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <typename XT>
__device__ __forceinline__ void store4(XT* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Four consecutive elements of q as f32 (16-byte aligned f32, 8-byte bf16).
__device__ __forceinline__ float4 load_q4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_q4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
}

// The absolute position slot s holds, and whether query position qp sees it.
__device__ __forceinline__ int slot_position(int s, int last, const Args& a) {
  if (!a.ring) return s;
  int m = (last - s) % a.S;
  if (m < 0) m += a.S;
  return last - m;
}
__device__ __forceinline__ bool visible(int qp, int kv, const Args& a) {
  bool ok = kv <= qp;
  if (a.ring)
    ok = ok && qp - kv < a.window && kv >= 0;
  else if (a.window > 0)
    ok = ok && qp - kv < a.window;
  return ok;
}

// Codebook entry of code E (a compile-time index) of word w: codes of BITS
// bits packed from bit 0; q8 reads the lane's own copy (lane4 = 4 * lane).
// The byte offset into the table is one shift and one mask of w.
template <int BITS, int E>
__device__ __forceinline__ float lookup(const float* tbl, uint32_t w,
                                        uint32_t lane4) {
  constexpr int kShift = BITS * E - (BITS == 8 ? 7 : 2);  // code -> offset
  constexpr uint32_t kMask = BITS == 8 ? 0x7F80u : 0x3Cu;
  uint32_t sh;
  if constexpr (kShift >= 0)
    sh = w >> kShift;
  else
    sh = w << -kShift;
  const uint32_t off = BITS == 8 ? (sh & kMask) | lane4 : sh & kMask;
  return *reinterpret_cast<const float*>(
      reinterpret_cast<const char*>(tbl) + off);
}

// Codebook value thread `tid` stores (entries past n_codes are 0).
__device__ __forceinline__ float table_entry(const Args& a, int e) {
  return e < a.n_codes ? __ldg(a.cb + e) : 0.f;
}

// The block fills the codebook table from `v` (entry tid + u * nthreads of
// thread tid): q8 entry e at words e*32 .. e*32 + 31, by 16-byte stores
// rotated by thread, so a quarter warp hits distinct banks; q4 its 16
// entries once (they lie in distinct banks).
template <int BITS, int U>
__device__ __forceinline__ void fill_table(float* tbl, const float (&v)[U],
                                           int tid, int nthreads) {
  if constexpr (BITS == 8) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = tid + u * nthreads;
      if (e >= 256) break;
      const float4 v4 = make_float4(v[u], v[u], v[u], v[u]);
      float4* row = reinterpret_cast<float4*>(tbl + e * 32);
#pragma unroll
      for (int c = 0; c < 8; ++c) row[(c + tid) & 7] = v4;
    }
  } else {
    if (tid < 16) tbl[tid] = v[0];
  }
}

// Sum 32 values x[i] over the warp so that lane l ends with the sum of x[l]
// in x[0]: at each step a lane keeps the half of its values whose index bit
// matches its lane bit and adds its partner's copy of them (31 shuffles).
template <int N>
__device__ __forceinline__ void butterfly(float (&x)[32], int lane) {
  if constexpr (N > 1) {
    constexpr int H = N / 2;
    const bool up = lane & H;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? x[i] : x[i + H];
      const float keep = up ? x[i + H] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, H);
    }
    butterfly<H>(x, lane);
  }
}

// ---------------------------------------------------------------------------
// The split combine: each block of the group's cluster (rank = split) left
// its partial at `part_s` in its shared memory, acc [RT][hd] then (m, l)
// [RT]; block `rank` combines the float4 items (row, 4 consecutive d) rank,
// rank + splits, ... of rows r < n_rows over every block, in rank order,
// through distributed shared memory, and writes them out.
template <typename XT>
__device__ void cluster_combine(const Args& a, float* part_s, int RT,
                                int n_rows, int b, int k, int r0) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int CL = a.splits, rank = (int)cl.block_rank();
  const int hd = a.hd, per_row = hd / 4, n_items = n_rows * per_row;
  const int G = a.H / a.K;
  for (int i = rank + (int)threadIdx.x * CL; i < n_items;
       i += (int)blockDim.x * CL) {
    const int r = i / per_row, d = (i % per_row) * 4;
    float2 ml[kMaxCluster];
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < CL) {
        const float* rp = cl.map_shared_rank(part_s, q);
        ml[q] = *reinterpret_cast<const float2*>(rp + RT * hd + 2 * r);
        v[q] = *reinterpret_cast<const float4*>(rp + r * hd + d);
      }
    float M = -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < CL) M = fmaxf(M, ml[q].x);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < CL) {
        const float w = ml[q].x == -INFINITY ? 0.f : expf(ml[q].x - M);
        L = fmaf(ml[q].y, w, L);
        A.x = fmaf(v[q].x, w, A.x);
        A.y = fmaf(v[q].y, w, A.y);
        A.z = fmaf(v[q].z, w, A.z);
        A.w = fmaf(v[q].w, w, A.w);
      }
    L = fmaxf(L, 1e-30f);
    const int row = r0 + r;
    store4<XT>(static_cast<XT*>(a.out) +
                   (((size_t)b * a.T + row / G) * a.H + k * G + row % G) * hd +
                   d,
               make_float4(A.x / L, A.y / L, A.z / L, A.w / L));
  }
  cl.sync();
}

// Words of attn_rows_kernel's shared memory before its partial: the codebook
// table, then (aliased) the warp merge: acc [NW][RT][hd], (m, l) [NW][RT],
// weights [NW][RT].
__host__ __device__ inline size_t rows_loop_words(int bits, int RT, int hd,
                                                  int warps) {
  const size_t table = bits == 8 ? kTable : 16;
  const size_t merge = (size_t)warps * RT * (hd + 3);
  return table > merge ? table : merge;
}
__host__ __device__ inline size_t rows_smem_bytes(int bits, int RT, int hd,
                                                  int warps) {
  return (rows_loop_words(bits, RT, hd, warps) + (size_t)RT * (hd + 2)) * 4;
}

// ---------------------------------------------------------------------------
// Decode rows on CUDA cores: RT query rows a tile (4 or 8), E elements of hd a
// lane (4 up to hd = 128, 8 up to 256), batches of PB = 32 / RT slots a warp.

template <int BITS, typename XT, int RT, int E>
__global__ void __launch_bounds__(kMaxWarps * 32)
    attn_rows_kernel(Args a) {
  constexpr int PB = 32 / RT;
  constexpr int NQ = E / 4;  // 4-element quads a lane per row
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NW = blockDim.x >> 5;
  const uint32_t lane4 = 4 * lane;
  const int split = blockIdx.x, group = blockIdx.y;
  const int bk = group / a.row_tiles, rt = group % a.row_tiles;
  const int b = bk / a.K, k = bk % a.K;
  const int G = a.H / a.K, r0 = rt * RT;
  const int n_rows = min(RT, a.T * G - r0);
  const int hd = a.hd, hdc = BITS == 4 ? hd / 2 : hd;
  const int nb = (a.S + PB - 1) / PB;  // batches of PB slots
  const int b_begin = (int)((long long)nb * split / a.splits);
  const int b_end = (int)((long long)nb * (split + 1) / a.splits);
  // this lane's (row, slot) pair after the butterfly
  const int rl = lane / PB, jl = lane % PB;

  // Every independent load first: the first batch's codes and scales, q,
  // the positions and the codebook.
  uint32_t kw[PB][NQ], vw[PB][NQ];
  float ksc = 0.f, vsc = 0.f;
  auto load_batch = [&](int bb) {
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const int s = bb * PB + j;
      const size_t row = ((size_t)b * a.S + s) * a.K + k;
#pragma unroll
      for (int qd = 0; qd < NQ; ++qd) {
        const int e0 = lane * E + 4 * qd;
        kw[j][qd] = vw[j][qd] = 0u;
        if (s < a.S && e0 < hd) {
          if constexpr (BITS == 4) {
            kw[j][qd] = __ldg(reinterpret_cast<const uint16_t*>(
                a.kc + row * hdc + e0 / 2));
            vw[j][qd] = __ldg(reinterpret_cast<const uint16_t*>(
                a.vc + row * hdc + e0 / 2));
          } else {
            kw[j][qd] = __ldg(reinterpret_cast<const uint32_t*>(
                a.kc + row * hdc + e0));
            vw[j][qd] = __ldg(reinterpret_cast<const uint32_t*>(
                a.vc + row * hdc + e0));
          }
        }
      }
    }
    const int s = bb * PB + jl;
    const size_t row = ((size_t)b * a.S + s) * a.K + k;
    ksc = s < a.S ? __ldg(a.ks + row) : 0.f;
    vsc = s < a.S ? __ldg(a.vs + row) : 0.f;
  };
  int bb = b_begin + warp;
  if (bb < b_end) load_batch(bb);

  float qf[RT][E];
  const XT* qb = static_cast<const XT*>(a.q);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r, t = row / G, h = k * G + row % G;
#pragma unroll
    for (int qd = 0; qd < NQ; ++qd) {
      const int e0 = lane * E + 4 * qd;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n_rows && e0 < hd)
        v = load_q4(qb + (((size_t)b * a.T + t) * a.H + h) * hd + e0);
      qf[r][4 * qd] = v.x;
      qf[r][4 * qd + 1] = v.y;
      qf[r][4 * qd + 2] = v.z;
      qf[r][4 * qd + 3] = v.w;
    }
  }
  const int* qpos_b = a.qpos + (size_t)b * a.T;
  const int last = __ldg(qpos_b + a.T - 1);
  const int qp = rl < n_rows ? __ldg(qpos_b + (r0 + rl) / G) : 0;
  float cbv[kMaxWarps];  // entries tid + u * blockDim.x (256 / 32 at most)
#pragma unroll
  for (int u = 0; u < kMaxWarps; ++u) {
    const int e = tid + u * blockDim.x;
    cbv[u] = e < (BITS == 8 ? 256 : 16) ? table_entry(a, e) : 0.f;
  }
  fill_table<BITS>(smem, cbv, tid, blockDim.x);
  __syncthreads();

  float acc[RT][E];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (; bb < b_end; bb += NW) {
    // partial dot products of the 32 (row, slot) pairs, pair r*PB + j
    float x[32];
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      float kf[E];
#pragma unroll
      for (int qd = 0; qd < NQ; ++qd) {
        kf[4 * qd] = lookup<BITS, 0>(smem, kw[j][qd], lane4);
        kf[4 * qd + 1] = lookup<BITS, 1>(smem, kw[j][qd], lane4);
        kf[4 * qd + 2] = lookup<BITS, 2>(smem, kw[j][qd], lane4);
        kf[4 * qd + 3] = lookup<BITS, 3>(smem, kw[j][qd], lane4);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qf[r][e], kf[e], d);
        x[r * PB + j] = d;
      }
    }
    butterfly<32>(x, lane);
    const int slot = bb * PB + jl;
    float sc = -INFINITY;
    if (slot < a.S && rl < n_rows)
      sc = visible(qp, slot_position(slot, last, a), a)
               ? x[0] * ksc * a.scale
               : kNegInf;
    // online softmax of the lane's row over the batch (PB lanes a row)
    float mx = sc;
#pragma unroll
    for (int o = PB / 2; o >= 1; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(m_run, mx);
    const float p = sc == -INFINITY ? 0.f : expf(sc - m_new);
    const float corr = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
    float ps = p;
#pragma unroll
    for (int o = PB / 2; o >= 1; o >>= 1)
      ps += __shfl_xor_sync(kFull, ps, o);
    l_run = fmaf(l_run, corr, ps);
    m_run = m_new;
    const float pv = p * vsc;

    // V of the batch: the next batch's loads go out first
    uint32_t vcur[PB][NQ];
#pragma unroll
    for (int j = 0; j < PB; ++j)
#pragma unroll
      for (int qd = 0; qd < NQ; ++qd) vcur[j][qd] = vw[j][qd];
    if (bb + NW < b_end) load_batch(bb + NW);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float c = __shfl_sync(kFull, corr, r * PB);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= c;
    }
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      float vf[E];
#pragma unroll
      for (int qd = 0; qd < NQ; ++qd) {
        vf[4 * qd] = lookup<BITS, 0>(smem, vcur[j][qd], lane4);
        vf[4 * qd + 1] = lookup<BITS, 1>(smem, vcur[j][qd], lane4);
        vf[4 * qd + 2] = lookup<BITS, 2>(smem, vcur[j][qd], lane4);
        vf[4 * qd + 3] = lookup<BITS, 3>(smem, vcur[j][qd], lane4);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float w = __shfl_sync(kFull, pv, r * PB + j);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(w, vf[e], acc[r][e]);
      }
    }
  }

  // Merge the warps in warp order through shared memory (over the table):
  // each warp's acc and (m, l), then the weights exp(m - M) of each (warp,
  // row), then one thread per float4 item (row, 4 consecutive d).
  __syncthreads();
  float* acc_s = smem;                           // [NW][RT][hd]
  float* ml_s = smem + (size_t)NW * RT * hd;     // [NW][RT][2]
  float* wt_s = ml_s + 2 * NW * RT;              // [NW][RT]
  if (jl == 0) {
    ml_s[(warp * RT + rl) * 2] = m_run;
    ml_s[(warp * RT + rl) * 2 + 1] = l_run;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int qd = 0; qd < NQ; ++qd) {
      const int e0 = lane * E + 4 * qd;
      if (e0 < hd)
        *reinterpret_cast<float4*>(acc_s + ((size_t)warp * RT + r) * hd +
                                   e0) =
            make_float4(acc[r][4 * qd], acc[r][4 * qd + 1],
                        acc[r][4 * qd + 2], acc[r][4 * qd + 3]);
    }
  __syncthreads();
  if (tid < NW * RT) {
    const int r = tid % RT;
    float M = -INFINITY;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, ml_s[(w * RT + r) * 2]);
    const float m = ml_s[tid * 2];
    wt_s[tid] = m == -INFINITY ? 0.f : expf(m - M);
  }
  __syncthreads();
  const int per_row = hd / 4;
  // this block's partial, past the merge in its shared memory
  float* part_s = smem + rows_loop_words(BITS, RT, hd, NW);
  for (int i = tid; i < n_rows * per_row; i += blockDim.x) {
    const int r = i / per_row, d = (i % per_row) * 4;
    float M = -INFINITY, L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < NW; ++w) {
      const float wt = wt_s[w * RT + r];
      M = fmaxf(M, ml_s[(w * RT + r) * 2]);
      L = fmaf(ml_s[(w * RT + r) * 2 + 1], wt, L);
      const float4 v = *reinterpret_cast<const float4*>(
          acc_s + ((size_t)w * RT + r) * hd + d);
      A.x = fmaf(v.x, wt, A.x);
      A.y = fmaf(v.y, wt, A.y);
      A.z = fmaf(v.z, wt, A.z);
      A.w = fmaf(v.w, wt, A.w);
    }
    if (a.splits == 1) {
      const int row = r0 + r, t = row / G, h = k * G + row % G;
      const float Lc = fmaxf(L, 1e-30f);
      store4<XT>(static_cast<XT*>(a.out) +
                     (((size_t)b * a.T + t) * a.H + h) * hd + d,
                 make_float4(A.x / Lc, A.y / Lc, A.z / Lc, A.w / Lc));
    } else {
      *reinterpret_cast<float4*>(part_s + (size_t)r * hd + d) = A;
      if (d == 0)
        *reinterpret_cast<float2*>(part_s + (size_t)RT * hd + 2 * r) =
            make_float2(M, L);
    }
  }
  if (a.splits > 1) cluster_combine<XT>(a, part_s, RT, n_rows, b, k, r0);
}

// The launch configuration of a grid whose `cluster` blocks along x form a
// cluster.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                int cluster) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Once per kernel and device: the dynamic shared memory it may take and
// clusters of more than 8 blocks.
template <typename Kernel>
cudaError_t configure(Kernel kernel, size_t smem, unsigned& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (configured >> dev & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) configured |= 1u << dev;
  return err;
}

// Launch `kernel` (one cluster a group where S is split), or with `info`
// set only report into it how many clusters of `a.splits` blocks the card
// can hold at once and the dynamic shared memory of a block.
template <typename Kernel>
int launch_or_query(Kernel kernel, const Args& a, int threads, size_t smem,
                    size_t smem_max, unsigned& configured,
                    cudaStream_t stream, int* info) {
  cudaError_t err = configure(kernel, smem_max, configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.splits, a.B * a.K * a.row_tiles);
  if (info != nullptr) {
    ClusterLaunch c(dim3(a.splits), threads, smem, stream, a.splits);
    info[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveClusters(info, kernel, &c.cfg);
  }
  if (a.splits == 1) {
    kernel<<<grid, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  ClusterLaunch c(grid, threads, smem, stream, a.splits);
  return (int)cudaLaunchKernelEx(&c.cfg, kernel, a);
}

template <int BITS, typename XT, int RT, int E>
int launch_rows(const Args& a, cudaStream_t stream, int* info) {
  static unsigned configured = 0;  // one bit per device
  return launch_or_query(attn_rows_kernel<BITS, XT, RT, E>, a, a.warps * 32,
                         rows_smem_bytes(BITS, RT, a.hd, a.warps),
                         rows_smem_bytes(BITS, RT, kMaxHd, kMaxWarps),
                         configured, stream, info);
}

template <int BITS, typename XT>
int dispatch_rows(const Args& a, cudaStream_t s, int* info) {
  const bool wide = a.hd > 128;
  if (a.row_tile == 4)
    return wide ? launch_rows<BITS, XT, 4, 8>(a, s, info)
                : launch_rows<BITS, XT, 4, 4>(a, s, info);
  if (a.row_tile == 8)
    return wide ? launch_rows<BITS, XT, 8, 8>(a, s, info)
                : launch_rows<BITS, XT, 8, 4>(a, s, info);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Prefill chunks on tensor cores (bf16 q, more than 8 rows, hd = 64 * NTW):
// tiles of 16 query rows, 8 warps, chunks of 64 slots; mma.sync.m16n8k16
// (bf16 in, f32 accumulate), lane g = lane / 4, t = lane % 4.
// * S = Q K^T: warp w takes slots 8w .. 8w + 7 of the chunk (one n8 tile).
//   The order of d inside a dot product is free: lane t owns the quarter
//   [t * hd/4, (t + 1) * hd/4) of every row, and k-step j feeds it elements
//   4j .. 4j + 3 of that quarter as k = 2t, 2t + 1, 2t + 8, 2t + 9. So a
//   lane's K codes are one contiguous load of its slot g's quarter row, and
//   its A fragments two 8-byte reads of q's quarter rows g and g + 8 (q is
//   staged in shared memory, quarters padded so the reads hit 32 banks).
//   K is the codebook entry rounded to bf16; its scale and hd^-0.5 multiply
//   the f32 score.
// * Online softmax in f32 on the accumulator fragments: row maxima and sums
//   over the 8 warps go through shared memory in warp order; P times the V
//   scale is rounded to bf16 into shared memory as the P.V A operand.
// * O += P V: warp w owns hd columns [w * 8 * NTW, (w + 1) * 8 * NTW); n8
//   tile i column n is d = w*8*NTW + n*NTW + i, so a lane's V codes of a
//   slot are NTW adjacent codes (one 4-, 2- or 1-byte load), and the warps
//   need no merge: the block's partial is the warps' columns side by side.
// * The chunks' code loads go out two chunks ahead (a register ring of 2).

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;   // query rows a block
constexpr int kChunk = 64;  // slots a chunk

template <int NTW>
struct Shape {
  static constexpr int HD = 64 * NTW;
  static constexpr int KSTEPS = HD / 16;
  static constexpr int CHW = HD / 4;         // elements of a lane's quarter
  static constexpr int CWP = CHW / 2 + 2;    // its words in q_s, padded
  static constexpr int QRS = 4 * CWP;        // words of a q_s row: 8 mod 32
  static constexpr int PRS = kChunk / 2 + 4; // words of a p_s row: 4 mod 32
  static constexpr int QW = kRows * QRS;
  static constexpr int PW = kRows * PRS;
};

// One lane's loads of one chunk.
template <int BITS, int NTW>
struct Chunk {
  // K codes of slot 8w + g, quarter t: CHW bytes (q8) or CHW / 2 (q4)
  static constexpr int KW = BITS == 8 ? 4 * NTW : 2 * NTW;
  uint32_t k[KW];
  // V codes, [k-step][slot 2t, 2t + 1, 2t + 8, 2t + 9]: NTW codes each
  uint32_t v[16];
  float ks[2], vs[2];  // scales of the lane's score columns 8w + 2t + e
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 pair {cb[code E0 of w0], cb[code E1 of w1]}.
template <int BITS, int E0, int E1>
__device__ __forceinline__ uint32_t pair(const float* tbl, uint32_t w0,
                                         uint32_t w1, uint32_t lane4) {
  return pack_bf16(lookup<BITS, E0>(tbl, w0, lane4),
                   lookup<BITS, E1>(tbl, w1, lane4));
}

template <int N>
__device__ __forceinline__ void load_words(uint32_t* w, const uint8_t* p,
                                           bool ok) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok) v = __ldg(reinterpret_cast<const uint4*>(p) + u);
      w[4 * u] = v.x, w[4 * u + 1] = v.y, w[4 * u + 2] = v.z,
      w[4 * u + 3] = v.w;
    }
  } else {
    uint2 v = make_uint2(0u, 0u);
    if (ok) v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  }
}

// Words of shared memory before the block's partial: table, q tile, P, row
// maxima and sums.
template <int BITS, int NTW>
__host__ __device__ constexpr size_t loop_words() {
  using Sh = Shape<NTW>;
  return (BITS == 8 ? kTable : 16) + Sh::QW + Sh::PW + 2 * kWarps * kRows;
}
template <int BITS, int NTW>
constexpr size_t smem_bytes() {
  return 4 * (loop_words<BITS, NTW>() + kRows * (64 * NTW + 2));
}

template <int BITS, int NTW>
__global__ void __launch_bounds__(kThreads, 1) attn_mma_kernel(Args a) {
  using Sh = Shape<NTW>;
  using Ch = Chunk<BITS, NTW>;
  constexpr int HD = Sh::HD;
  extern __shared__ __align__(16) float smem[];
  float* tbl = smem;
  uint32_t* q_s = reinterpret_cast<uint32_t*>(smem + (BITS == 8 ? kTable
                                                                : 16));
  uint32_t* p_s = q_s + Sh::QW;
  float* red_m = reinterpret_cast<float*>(p_s + Sh::PW);  // [warp][row]
  float* red_l = red_m + kWarps * kRows;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t lane4 = 4 * lane;
  const int split = blockIdx.x, group = blockIdx.y;
  const int bk = group / a.row_tiles, rt = group % a.row_tiles;
  const int b = bk / a.K, k = bk % a.K;
  const int G = a.H / a.K, r0 = rt * kRows;
  const int n_rows = min(kRows, a.T * G - r0);
  const int hdc = BITS == 4 ? HD / 2 : HD;
  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  const int c_begin = (int)((long long)n_chunks * split / a.splits);
  const int c_end = (int)((long long)n_chunks * (split + 1) / a.splits);
  const size_t kv_b = (size_t)b * a.S;

  auto load_chunk = [&](int c, Ch& ch) {
    const int s0 = c * kChunk;
    {
      const int s = s0 + 8 * warp + g;
      const uint8_t* p = a.kc + ((kv_b + s) * a.K + k) * hdc +
                         t * (BITS == 8 ? Sh::CHW : Sh::CHW / 2);
      load_words<Ch::KW>(ch.k, p, s < a.S);
    }
    const int d0 = warp * 8 * NTW + g * NTW;  // the lane's V columns
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int s = s0 + 16 * (u >> 2) + 2 * t + (u & 1) + 8 * ((u >> 1) & 1);
      uint32_t v = 0u;
      if (s < a.S) {
        const uint8_t* row = a.vc + ((kv_b + s) * a.K + k) * hdc;
        if constexpr (BITS == 8) {
          if constexpr (NTW == 4)
            v = __ldg(reinterpret_cast<const uint32_t*>(row + d0));
          else if constexpr (NTW == 2)
            v = __ldg(reinterpret_cast<const uint16_t*>(row + d0));
          else
            v = __ldg(row + d0);
        } else {
          if constexpr (NTW == 4)
            v = __ldg(reinterpret_cast<const uint16_t*>(row + d0 / 2));
          else if constexpr (NTW == 2)
            v = __ldg(row + d0 / 2);
          else
            v = (__ldg(row + d0 / 2) >> (4 * (d0 & 1))) & 0xFu;
        }
      }
      ch.v[u] = v;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = s0 + 8 * warp + 2 * t + e;
      const size_t row = (kv_b + s) * a.K + k;
      ch.ks[e] = s < a.S ? __ldg(a.ks + row) : 0.f;
      ch.vs[e] = s < a.S ? __ldg(a.vs + row) : 0.f;
    }
  };

  // Every independent load first: two chunks of codes, q, the positions and
  // the codebook.
  Ch ch0, ch1;
  if (c_begin < c_end) load_chunk(c_begin, ch0);
  if (c_begin + 1 < c_end) load_chunk(c_begin + 1, ch1);
  const uint16_t* qb = static_cast<const uint16_t*>(a.q);
  uint2 qv[NTW];  // 4 bf16 of q a unit: row i / (HD/4), elements 4 (i % ..)
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int i = tid + u * kThreads, r = i / (HD / 4);
    const int e0 = (i % (HD / 4)) * 4, row = r0 + r;
    qv[u] = make_uint2(0u, 0u);
    if (r < n_rows)
      qv[u] = __ldg(reinterpret_cast<const uint2*>(
          qb + (((size_t)b * a.T + row / G) * a.H + k * G + row % G) * HD +
          e0));
  }
  const int* qpos_b = a.qpos + (size_t)b * a.T;
  const int last = __ldg(qpos_b + a.T - 1);
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qp[h] = g + 8 * h < n_rows ? __ldg(qpos_b + (r0 + g + 8 * h) / G) : 0;
  const float cbv[1] = {tid < (BITS == 8 ? 256 : 16) ? table_entry(a, tid)
                                                     : 0.f};
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const int i = tid + u * kThreads, r = i / (HD / 4);
    const int e0 = (i % (HD / 4)) * 4;
    *reinterpret_cast<uint2*>(q_s + r * Sh::QRS + (e0 / Sh::CHW) * Sh::CWP +
                              (e0 % Sh::CHW) / 2) = qv[u];
  }
  fill_table<BITS>(tbl, cbv, tid, kThreads);
  __syncthreads();

  float o[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  auto step = [&](int c, const Ch& ch) {
    const int s0 = c * kChunk;
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < Sh::KSTEPS; ++j) {
      const uint2 a02 = *reinterpret_cast<const uint2*>(
          q_s + g * Sh::QRS + t * Sh::CWP + 2 * j);
      const uint2 a13 = *reinterpret_cast<const uint2*>(
          q_s + (g + 8) * Sh::QRS + t * Sh::CWP + 2 * j);
      // the 4 codes of elements 4j .. 4j + 3 of the lane's quarter
      const uint32_t kw = BITS == 8 ? ch.k[j]
                                    : ch.k[j >> 1] >> (16 * (j & 1));
      mma_16816(sacc, a02.x, a13.x, a02.y, a13.y,
                pair<BITS, 0, 1>(tbl, kw, kw, lane4),
                pair<BITS, 2, 3>(tbl, kw, kw, lane4));
    }
    // masked, scaled scores of rows g, g + 8 and columns 2t, 2t + 1
    float sc[2][2], mx[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int slot = s0 + 8 * warp + 2 * t + e;
        sc[h][e] = -INFINITY;
        if (slot < a.S && g + 8 * h < n_rows)
          sc[h][e] = visible(qp[h], slot_position(slot, last, a), a)
                         ? sacc[2 * h + e] * ch.ks[e] * a.scale
                         : kNegInf;
      }
      mx[h] = fmaxf(sc[h][0], sc[h][1]);
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      if (t == 0) red_m[warp * kRows + g + 8 * h] = mx[h];
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        cm = fmaxf(cm, red_m[w * kRows + g + 8 * h]);
      const float m_new = fmaxf(m_run[h], cm);
      corr[h] = m_run[h] == -INFINITY ? 0.f : expf(m_run[h] - m_new);
      m_run[h] = m_new;
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        p[e] = sc[h][e] == -INFINITY ? 0.f : expf(sc[h][e] - m_new);
      float ps = p[0] + p[1];
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      if (t == 0) red_l[warp * kRows + g + 8 * h] = ps;
      p_s[(g + 8 * h) * Sh::PRS + 4 * warp + t] =
          pack_bf16(p[0] * ch.vs[0], p[1] * ch.vs[1]);
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ls += red_l[w * kRows + g + 8 * h];
      l_run[h] = fmaf(l_run[h], corr[h], ls);
    }
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      o[i][0] *= corr[0], o[i][1] *= corr[0];
      o[i][2] *= corr[1], o[i][3] *= corr[1];
    }
    // P.V; the next chunk's writes of red_m, red_l and p_s come after its
    // first barrier, when every warp is done with this chunk's
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      const uint32_t a0 = p_s[g * Sh::PRS + 8 * ks + t];
      const uint32_t a1 = p_s[(g + 8) * Sh::PRS + 8 * ks + t];
      const uint32_t a2 = p_s[g * Sh::PRS + 8 * ks + 4 + t];
      const uint32_t a3 = p_s[(g + 8) * Sh::PRS + 8 * ks + 4 + t];
      const uint32_t* v = ch.v + 4 * ks;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        uint32_t b0, b1;  // code i of slots 2t, 2t + 1 and 2t + 8, 2t + 9
        if (i == 0) {
          b0 = pair<BITS, 0, 0>(tbl, v[0], v[1], lane4);
          b1 = pair<BITS, 0, 0>(tbl, v[2], v[3], lane4);
        } else if (i == 1) {
          b0 = pair<BITS, 1, 1>(tbl, v[0], v[1], lane4);
          b1 = pair<BITS, 1, 1>(tbl, v[2], v[3], lane4);
        } else if (i == 2) {
          b0 = pair<BITS, 2, 2>(tbl, v[0], v[1], lane4);
          b1 = pair<BITS, 2, 2>(tbl, v[2], v[3], lane4);
        } else {
          b0 = pair<BITS, 3, 3>(tbl, v[0], v[1], lane4);
          b1 = pair<BITS, 3, 3>(tbl, v[2], v[3], lane4);
        }
        mma_16816(o[i], a0, a1, a2, a3, b0, b1);
      }
    }
  };

  for (int c = c_begin; c < c_end; c += 2) {
    step(c, ch0);
    if (c + 2 < c_end) load_chunk(c + 2, ch0);
    if (c + 1 < c_end) {
      step(c + 1, ch1);
      if (c + 3 < c_end) load_chunk(c + 3, ch1);
    }
  }

  // accumulator e of n8 tile i: row g + 8 (e >> 1), column d; the partial
  // goes past the loop's shared memory
  float* part_s = smem + loop_words<BITS, NTW>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h, row = r0 + r;
    const float L = fmaxf(l_run[h], 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) +
                         (((size_t)b * a.T + row / G) * a.H + k * G + row % G) *
                             HD;
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = warp * 8 * NTW + (2 * t + e) * NTW + i;
        if (a.splits == 1) {
          if (r < n_rows) out[d] = __float2bfloat16(o[i][2 * h + e] / L);
        } else {
          part_s[(size_t)r * HD + d] = o[i][2 * h + e];
        }
      }
    if (a.splits > 1 && warp == 0 && t == 0)
      *reinterpret_cast<float2*>(part_s + (size_t)kRows * HD + 2 * r) =
          make_float2(m_run[h], l_run[h]);
  }
  if (a.splits > 1)
    cluster_combine<__nv_bfloat16>(a, part_s, kRows, n_rows, b, k, r0);
}

template <int BITS, int NTW>
int launch(const Args& a, cudaStream_t stream, int* info) {
  static unsigned configured = 0;  // one bit per device
  constexpr size_t smem = smem_bytes<BITS, NTW>();
  return launch_or_query(attn_mma_kernel<BITS, NTW>, a, kThreads, smem, smem,
                         configured, stream, info);
}

template <int BITS>
int dispatch(const Args& a, cudaStream_t s, int* info) {
  switch (a.hd) {
    case 64: return launch<BITS, 1>(a, s, info);
    case 128: return launch<BITS, 2>(a, s, info);
    case 256: return launch<BITS, 4>(a, s, info);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

// Checks the shape, then launches (or, with `info`, queries) the instance
// that `path`, `bits`, the q type, `row_tile` and hd name.
int run(const void* q, const void* k_codes, const void* k_scales,
        const void* v_codes, const void* v_scales, const void* codebook,
        const void* q_positions, void* out, int q_is_bf16, int B, int T,
        int H, int K, int hd, int S, int bits, int n_codes, int window,
        int ring, int path, int row_tile, int warps, int splits, float scale,
        cudaStream_t s, int* info) {
  const bool tc = path == 1;
  if (B < 1 || T < 1 || K < 1 || H < K || H % K || hd < 4 || hd > kMaxHd ||
      hd % 4 || S < 1 || (bits != 4 && bits != 8) || n_codes < 1 ||
      n_codes > (bits == 4 ? 16 : 256) || splits < 1 ||
      splits > kMaxCluster || (path != 0 && path != 1) ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  if (tc ? (!q_is_bf16 || row_tile != tc::kRows || warps != tc::kWarps ||
            (hd != 64 && hd != 128 && hd != 256) ||
            reinterpret_cast<uintptr_t>(k_codes) % 16 ||
            reinterpret_cast<uintptr_t>(v_codes) % 16)
         : ((row_tile != 4 && row_tile != 8) || warps < 1 ||
            warps > kMaxWarps))
    return (int)cudaErrorInvalidValue;
  const int rows = T * (H / K);
  const Args a{q, static_cast<const uint8_t*>(k_codes),
               static_cast<const float*>(k_scales),
               static_cast<const uint8_t*>(v_codes),
               static_cast<const float*>(v_scales),
               static_cast<const float*>(codebook),
               static_cast<const int*>(q_positions), out,
               B, T, H, K, hd, S, n_codes, window, ring,
               row_tile, (rows + row_tile - 1) / row_tile, warps, splits,
               scale};
  if (tc)
    return bits == 4 ? tc::dispatch<4>(a, s, info)
                     : tc::dispatch<8>(a, s, info);
  if (q_is_bf16)
    return bits == 4 ? dispatch_rows<4, __nv_bfloat16>(a, s, info)
                     : dispatch_rows<8, __nv_bfloat16>(a, s, info);
  return bits == 4 ? dispatch_rows<4, float>(a, s, info)
                   : dispatch_rows<8, float>(a, s, info);
}

}  // namespace

// Launch on `stream`. q (B, T, H, hd) in bf16 or f32; k/v codes (B, S, K,
// hd or hd/2) uint8; k/v scales (B, S, K, 1) f32; codebook (n_codes,) f32;
// q_positions (B, T) int32; out (B, T, H, hd) in q's dtype. `scale` is
// hd^-0.5; hd <= 256 and hd % 4 == 0; q 16-byte aligned.
//
// path 0: attn_rows_kernel, `row_tile` 4 or 8 query rows a block, `warps`
// (1..8) warps a block. path 1: attn_mma_kernel, bf16 q, hd 64, 128 or 256,
// codes 16-byte aligned, `row_tile` 16 and `warps` 8. S is split into
// `splits` (1..16) blocks a group of (b, kv head, row tile); with splits > 1
// they are one thread block cluster. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* codebook,
    const void* q_positions, void* out, int q_is_bf16, int B, int T, int H,
    int K, int hd, int S, int bits, int n_codes, int window, int ring,
    int path, int row_tile, int warps, int splits, float scale,
    void* stream) {
  return run(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions,
             out, q_is_bf16, B, T, H, K, hd, S, bits, n_codes, window, ring,
             path, row_tile, warps, splits, scale,
             static_cast<cudaStream_t>(stream), nullptr);
}

// Into info[0]: how many clusters of `splits` blocks of the instance (path,
// bits, q type, row_tile, hd, warps) the card can hold at once (0: the
// cluster cannot be scheduled); into info[1]: the dynamic shared memory of
// one of its blocks, in bytes. Returns the cudaError_t (0 on success).
extern "C" int decode_attention_instance_info(int path, int bits,
                                              int q_is_bf16, int row_tile,
                                              int hd, int warps, int splits,
                                              int* info) {
  alignas(16) static const char dummy[16] = {};
  const int H = path == 1 ? row_tile : 1;
  return run(dummy, dummy, nullptr, dummy, nullptr, nullptr, nullptr,
             nullptr, q_is_bf16, 1, 1, H, 1, hd, 1, bits, 1, 0, 0, path,
             row_tile, warps, splits, 1.f, nullptr, info);
}
