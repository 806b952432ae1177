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
// Masked scores are -1e30, not -inf, as in the reference, so a padded query
// row stays finite.
//
// Bound. Per call it reads the layer's K and V codes once (2*B*S*K*hdc
// bytes plus 8 bytes of scales per row) and does 4*B*T*H*S*hd flops. At
// gemma3-1b's shapes (B = 4, K = 1, H = 4, hd = 256, S = 520 or 1032) that
// is 0.3-2 MB, under a microsecond of the card's bandwidth: the kernel is
// bound by latency (a chain of dependent loads and barriers per chunk), so
// the design spreads the chunks over many blocks.
//
// Design.
// * S is split across blocks (flash-decode): one block per (b, kv head k,
//   split of S, tile of up to kRowTile query rows), with enough splits for
//   about two blocks per SM (the caller picks `splits`). The T*G query rows
//   of a head group share each dequantised chunk.
// * A block streams its chunks of kChunk slots: each thread issues all its
//   code and scale loads of the chunk (4 codes per load) before dequantising
//   them into shared memory (rows padded to hd + 4 floats, so the score
//   loop's float4 reads hit distinct banks); scores are f32 dot products,
//   then an online softmax (running max m, sum l, accumulator acc, all f32
//   in shared memory) folds the chunk in.
// * One split writes acc / max(l, 1e-30) directly; several write their
//   (m, l, acc) to f32 scratch and a second kernel combines them in a fixed
//   order: M = max m, out = sum(acc * exp(m - M)) / max(sum(l * exp(m - M)),
//   1e-30), the same function as one sweep.
// Tensor cores and an asynchronous copy pipeline are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // cache slots per chunk (one per lane)
constexpr int kRowTile = 32;   // query rows per block
constexpr int kMaxHd = 256;
constexpr int kGroups = kChunk * kMaxHd / 4 / kThreads;  // loads per thread
constexpr float kNegInf = -1e30f;

struct GeometryA {
  int B, T, H, K, hd, S, n_codes, window, ring, splits;
  float scale;
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

// shared memory in floats: codebook, q rows, K and V chunks, probabilities,
// accumulator, per-row m / l / correction; then ints: query and slot positions
__host__ __device__ inline size_t smem_floats(int hd) {
  return 256 + (size_t)kRowTile * hd + 2 * (size_t)kChunk * (hd + 4) +
         (size_t)kRowTile * kChunk + (size_t)kRowTile * hd + 3 * kRowTile;
}

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_quant_kernel(
        const XT* __restrict__ q, const uint8_t* __restrict__ k_codes,
        const float* __restrict__ k_scales, const uint8_t* __restrict__ v_codes,
        const float* __restrict__ v_scales, const float* __restrict__ codebook,
        const int* __restrict__ q_positions, XT* __restrict__ out,
        float* __restrict__ part_ml, float* __restrict__ part_acc,
        GeometryA g) {
  extern __shared__ float smem[];
  const int hd = g.hd, hp = g.hd + 4;
  float* cb_s = smem;
  float* qs = cb_s + 256;                     // kRowTile x hd
  float* ks = qs + kRowTile * hd;             // kChunk x (hd + 4)
  float* vs = ks + kChunk * hp;               // kChunk x (hd + 4)
  float* ps = vs + kChunk * hp;               // kRowTile x kChunk
  float* acc = ps + kRowTile * kChunk;        // kRowTile x hd
  float* m_s = acc + kRowTile * hd;           // kRowTile
  float* l_s = m_s + kRowTile;
  float* corr_s = l_s + kRowTile;
  int* qp_s = reinterpret_cast<int*>(corr_s + kRowTile);  // kRowTile
  int* kv_s = qp_s + kRowTile;                             // kChunk

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x, k = blockIdx.y;
  const int split = blockIdx.z % g.splits;
  const int G = g.H / g.K;
  const int n_rows_all = g.T * G;
  const int r0 = (blockIdx.z / g.splits) * kRowTile;
  const int n_rows = min(kRowTile, n_rows_all - r0);
  const int hdc = BITS == 4 ? hd / 2 : hd;
  const int per_row = hd / 4;                 // 4-element groups per row
  const int* qpos_b = q_positions + (size_t)b * g.T;
  const int last = qpos_b[g.T - 1];
  const int n_chunks = (g.S + kChunk - 1) / kChunk;
  const int c_begin = n_chunks * split / g.splits;
  const int c_end = n_chunks * (split + 1) / g.splits;

  for (int i = tid; i < 256; i += kThreads)
    cb_s[i] = i < g.n_codes ? codebook[i] : 0.f;
  for (int i = tid; i < n_rows * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    const int t = (r0 + r) / G, h = k * G + (r0 + r) % G;
    qs[i] = to_f32(q[(((size_t)b * g.T + t) * g.H + h) * hd + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    qp_s[r] = qpos_b[(r0 + r) / G];
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int s0 = c * kChunk;
    // every code and scale load of the chunk first, so they are in flight
    // together; 4 codes per load (hd % 4 == 0)
    uint32_t kw[kGroups], vw[kGroups];
    float ksc[kGroups], vsc[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int i = tid + u * kThreads;
      const int s = i / per_row, d = (i % per_row) * 4;
      kw[u] = vw[u] = 0u;
      ksc[u] = vsc[u] = 0.f;
      if (s < kChunk && s0 + s < g.S) {
        const size_t row = ((size_t)b * g.S + s0 + s) * g.K + k;
        if constexpr (BITS == 4) {
          kw[u] = *reinterpret_cast<const uint16_t*>(k_codes + row * hdc + d / 2);
          vw[u] = *reinterpret_cast<const uint16_t*>(v_codes + row * hdc + d / 2);
        } else {
          kw[u] = *reinterpret_cast<const uint32_t*>(k_codes + row * hdc + d);
          vw[u] = *reinterpret_cast<const uint32_t*>(v_codes + row * hdc + d);
        }
        ksc[u] = k_scales[row];
        vsc[u] = v_scales[row];
      }
    }
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int i = tid + u * kThreads;
      const int s = i / per_row, d = (i % per_row) * 4;
      if (s < kChunk) {
        float4 kv4, vv4;
        float* kf = &kv4.x;
        float* vf = &vv4.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int shift = (BITS == 4 ? 4 : 8) * e;
          const uint32_t mask = BITS == 4 ? 0xFu : 0xFFu;
          kf[e] = cb_s[(kw[u] >> shift) & mask] * ksc[u];
          vf[e] = cb_s[(vw[u] >> shift) & mask] * vsc[u];
        }
        *reinterpret_cast<float4*>(ks + s * hp + d) = kv4;
        *reinterpret_cast<float4*>(vs + s * hp + d) = vv4;
      }
    }
    if (tid < kChunk) {
      const int slot = s0 + tid;
      int pos = slot;
      if (g.ring) {
        int m = (last - slot) % g.S;
        if (m < 0) m += g.S;
        pos = last - m;
      }
      kv_s[tid] = pos;
    }
    __syncthreads();

    // masked, scaled scores; slots past S take no part (-inf, weight 0)
    for (int i = tid; i < n_rows * kChunk; i += kThreads) {
      const int r = i / kChunk, s = i % kChunk;
      float sc = -INFINITY;
      if (s0 + s < g.S) {
        const float* qr = qs + r * hd;
        const float* kr = ks + s * hp;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        for (int d = 0; d < hd; d += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qr + d);
          const float4 w = *reinterpret_cast<const float4*>(kr + d);
          d0 = fmaf(a.x, w.x, d0);
          d1 = fmaf(a.y, w.y, d1);
          d2 = fmaf(a.z, w.z, d2);
          d3 = fmaf(a.w, w.w, d3);
        }
        const int qp = qp_s[r], kvp = kv_s[s];
        bool ok = kvp <= qp;
        if (g.ring)
          ok = ok && qp - kvp < g.window && kvp >= 0;
        else if (g.window > 0)
          ok = ok && qp - kvp < g.window;
        sc = ok ? ((d0 + d1) + (d2 + d3)) * g.scale : kNegInf;
      }
      ps[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp per row, one lane per slot of the chunk
    for (int r = warp; r < n_rows; r += kWarps) {
      const float sc = ps[r * kChunk + lane];
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[r * kChunk + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < n_rows * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const float* pr = ps + r * kChunk;
      float a = acc[i] * corr_s[r];
#pragma unroll 8
      for (int s = 0; s < kChunk; ++s) a = fmaf(pr[s], vs[s * hp + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  if (g.splits == 1) {
    for (int i = tid; i < n_rows * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const int t = (r0 + r) / G, h = k * G + (r0 + r) % G;
      out[(((size_t)b * g.T + t) * g.H + h) * hd + d] =
          from_f32<XT>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }
  // partials of row (b, k, split, r): (m, l) and the unnormalised acc
  const size_t base = (((size_t)b * g.K + k) * g.splits + split) * n_rows_all + r0;
  for (int r = tid; r < n_rows; r += kThreads) {
    part_ml[(base + r) * 2] = m_s[r];
    part_ml[(base + r) * 2 + 1] = l_s[r];
  }
  for (int i = tid; i < n_rows * hd; i += kThreads)
    part_acc[base * hd + i] = acc[i];
}

// One block per (b, k, query row): combine the splits' partials in split
// order, one thread per element of hd.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
    combine_splits_kernel(const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc,
                          XT* __restrict__ out, GeometryA g) {
  const int G = g.H / g.K;
  const int n_rows_all = g.T * G;
  const int r = blockIdx.x % n_rows_all;
  const int bk = blockIdx.x / n_rows_all;
  const int b = bk / g.K, k = bk % g.K;
  const int d = threadIdx.x;
  const size_t base = (size_t)bk * g.splits * n_rows_all + r;
  float M = -INFINITY;
  for (int sp = 0; sp < g.splits; ++sp)
    M = fmaxf(M, part_ml[(base + (size_t)sp * n_rows_all) * 2]);
  float L = 0.f, a = 0.f;
  for (int sp = 0; sp < g.splits; ++sp) {
    const size_t row = base + (size_t)sp * n_rows_all;
    const float w = expf(part_ml[row * 2] - M);
    L = fmaf(part_ml[row * 2 + 1], w, L);
    if (d < g.hd) a = fmaf(part_acc[row * g.hd + d], w, a);
  }
  if (d < g.hd) {
    const int t = r / G, h = k * G + r % G;
    out[(((size_t)b * g.T + t) * g.H + h) * g.hd + d] =
        from_f32<XT>(a / fmaxf(L, 1e-30f));
  }
}

template <int BITS, typename XT>
cudaError_t launch(const void* q, const void* kc, const void* ks,
                   const void* vc, const void* vs, const void* cb,
                   const void* qpos, void* out, void* part_ml,
                   void* part_acc, const GeometryA& g, cudaStream_t stream) {
  const size_t smem = smem_floats(g.hd) * sizeof(float) +
                      (kRowTile + kChunk) * sizeof(int);
  auto kernel = decode_attention_quant_kernel<BITS, XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = g.T * (g.H / g.K);
  dim3 grid(g.B, g.K, ((rows + kRowTile - 1) / kRowTile) * g.splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const float*>(ks), static_cast<const uint8_t*>(vc),
      static_cast<const float*>(vs), static_cast<const float*>(cb),
      static_cast<const int*>(qpos), static_cast<XT*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.splits == 1) return err;
  combine_splits_kernel<XT><<<g.B * g.K * rows, kThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<XT*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`. q (B, T, H, hd) in bf16 or f32; k/v codes (B, S, K,
// hd or hd/2) uint8; k/v scales (B, S, K, 1) f32; codebook (n_codes,) f32;
// q_positions (B, T) int32; out (B, T, H, hd) in q's dtype. `scale` is
// hd^-0.5; hd <= 256 and hd % 4 == 0. `splits` (1 .. number of 32-slot
// chunks) divides S across blocks; with splits > 1, part_ml and part_acc
// are f32 scratch of splits*B*K*T*(H/K)*2 and *hd elements. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int decode_attention_quant_launch(
    const void* q, const void* k_codes, const void* k_scales,
    const void* v_codes, const void* v_scales, const void* codebook,
    const void* q_positions, void* out, void* part_ml, void* part_acc,
    int q_is_bf16, int B, int T, int H, int K, int hd, int S, int bits,
    int n_codes, int window, int ring, int splits, float scale,
    void* stream) {
  if (B < 1 || T < 1 || K < 1 || H < K || H % K || hd < 4 || hd > kMaxHd ||
      hd % 4 || S < 1 || (bits != 4 && bits != 8) || n_codes < 1 ||
      n_codes > (bits == 4 ? 16 : 256) || splits < 1 ||
      splits > (S + kChunk - 1) / kChunk ||
      (splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const GeometryA g{B, T, H, K, hd, S, n_codes, window, ring, splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_is_bf16)
    err = bits == 4
              ? launch<4, __nv_bfloat16>(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions, out, part_ml, part_acc, g, s)
              : launch<8, __nv_bfloat16>(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions, out, part_ml, part_acc, g, s);
  else
    err = bits == 4
              ? launch<4, float>(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions, out, part_ml, part_acc, g, s)
              : launch<8, float>(q, k_codes, k_scales, v_codes, v_scales, codebook, q_positions, out, part_ml, part_acc, g, s);
  return (int)err;
}
