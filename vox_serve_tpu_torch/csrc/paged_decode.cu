// K1, K1q and K4: paged decode attention for Hopper (sm_90a).
//
// One query token per sequence attends over the pages of its block table.
// Keys j < seq_len only; f32 scores and softmax. GQA: query heads
// h*G .. h*G+G-1 read KV head h. Two pool layouts, one kernel template:
//
//   * combined (K1, K1q): the (L, P, page, 2*KH, D) pool, K at even and V
//     at odd combined heads, the layer chosen by adding layer*P to the page
//     id. Replaces the TPU kernel reached from vox_serve_tpu/ops/attention.py
//     `paged_attention_decode` (combined branch), jax's stock Pallas
//     `ragged_paged_attention`: over a bf16 pool (K1), or over an int8 or
//     float8 e4m3 pool dequantised by the static `k_scale`/`v_scale` (K1q,
//     attention.py:300-309). The element type is a template parameter;
//     k_scale is folded into the query scale and v_scale multiplies the
//     merged output, which is exact up to f32 rounding.
//   * pair (K4): head-major k, v: (L, KH, P, page, D) each; head h of token
//     t of page p at (((layer*KH + h)*P + p)*page + t)*D. Replaces
//     vox_serve_tpu/ops/pallas_attention.py `_pallas_decode_call` (both its
//     per-request kernel and its lane-folding kernel for D < 128: the fold
//     is a TPU lane artefact, a warp reads D < 128 with idle lanes).
//
// What bounds it on an H100: bytes at large batch (every K/V element is read
// once and used for 2*G flops, G = 2 for Qwen3-TTS and 3 for Orpheus's
// Llama-3.2-3B, far below the ~295
// flop/byte ridge) and latency at the serving batch (B = 4, tens of pages),
// where the whole read is ~1 MB and the launch, one trip to memory and the
// merge are the time.
//
// Design (page-parallel split-KV):
//   * the unit of work is a tile of 16 consecutive tokens (one page at the
//     default page size). Each lane moves 16 bytes per row: a 128-dim row
//     is 16 lanes in bf16 or 8 lanes in a 1-byte type, so one warp load
//     covers 2 or 4 rows and a tile is 8 or 4 loads each of K and V;
//   * a warp stages its tile by cp.async into its own double-buffered slot
//     of shared memory and issues the next tile's copies before it computes
//     the current one. Every lane reads back only the 16-byte pieces it
//     copied itself, so no barrier sits inside the loop;
//   * per tile, each row's dot product is reduced inside its lane group
//     (4 or 3 shuffles), and the online softmax max/sum/rescale runs once
//     per tile and head, not once per token; exp2 with log2(e) folded into
//     the query scale;
//   * the grid is (B, KH * head groups, splits). A CTA holds up to 4 query
//     heads of one KV group, so each K/V row read serves all of them: G <= 4
//     is one head group of G heads; a larger G takes ceil(G / 4) groups of
//     4, the last one masked where 4 does not divide G (G = 7: 4 + 3, the
//     tail head loads a zero query and stores nothing), so no group needs
//     more registers than G = 4 does. The mask lives in its own instance
//     (kTail), so every other G runs the machine code it ran before the
//     mask existed. `splits` (ops/kernels.py plan_decode_splits)
//     cuts each sequence's tiles into contiguous ranges so that small
//     batches still fill the 132 SMs; the four warps of a CTA take the
//     tiles of its range round-robin and merge in shared memory;
//   * the splits of one (sequence, head group) merge in the same launch by
//     the log-sum-exp rule: each CTA writes its (max, sum, acc) to a scratch
//     buffer, and the CTA that finds itself last on an atomic counter
//     merges them and writes the output, then resets the counter to zero
//     for the next launch. With one split the CTA writes the output itself;
//   * pool offsets are computed in 64 bits: the flagship pool with P=4096
//     holds 28*4096*16*16*128 ~ 3.8e9 elements, past int32;
//   * seq_len == 0 gives a zero output (padded batch rows use seq_len 1 on
//     scratch page 0, so serving never sends 0).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;        // head dim
constexpr int kTile = 16;         // tokens per tile
constexpr int kMaxHeads = 4;      // query heads per CTA
constexpr int kMaxSplits = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of pool elements -> f32 (8 bf16 or 16 one-byte values)
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ __forceinline__ static void cvt(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int kPer = 16;
  __device__ __forceinline__ static void cvt(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] = static_cast<float>(
            static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
    }
  }
};

template <>
struct Elem<__nv_fp8_e4m3> {
  static constexpr int kPer = 16;
  __device__ __forceinline__ static void cvt(const uint4& r, float* o) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_fp8x4_e4m3 x;
      x.__x = w[i];
      const float4 f = static_cast<float4>(x);
      o[4 * i] = f.x;
      o[4 * i + 1] = f.y;
      o[4 * i + 2] = f.z;
      o[4 * i + 3] = f.w;
    }
  }
};

template <typename T>
constexpr int stage_bytes() {
  // K and V of one tile: (kTile / rows per load) loads x 32 lanes x 16 B
  return 2 * (kTile / (32 / (kMaxD / Elem<T>::kPer))) * 32 * 16;
}

template <typename T>
constexpr int smem_bytes() {
  return kWarps * 2 * stage_bytes<T>();  // two stages per warp
}

// kPair = false: `kp` is the combined pool and `vp` is unused.
// kPair = true: `kp` and `vp` are the head-major K and V pools.
// kG: query heads per CTA (G where G <= 4, else 4). kTail: kG does not
// divide G, so the last head group of each KV head is masked.
template <typename T, bool kPair, int kG, bool kTail>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part,  // splits > 1: per-CTA states
                    int* __restrict__ counters,
                    int H, int KH, int D, int P, int page, int max_pages,
                    int layer, float qk_scale, float v_scale) {
  constexpr int EPL = Elem<T>::kPer;      // elements per lane per row
  constexpr int LPR = kMaxD / EPL;        // lanes per row: 16 or 8
  constexpr int RPL = 32 / LPR;           // rows per warp load: 2 or 4
  constexpr int NL = kTile / RPL;         // loads per tile: 8 or 4
  constexpr int kChunks = NL * 32;        // 16-byte pieces per matrix
  extern __shared__ uint4 smem[];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int hy = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int G = H / KH;
  const int hgroups = kTail ? (G + kG - 1) / kG : G / kG;
  const int kvh = hy / hgroups;
  const int g0 = (hy - kvh * hgroups) * kG;  // first head within the group
  const int nh = kTail ? min(kG, G - g0) : kG;  // heads of this CTA
  const int head0 = kvh * G + g0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r_in = lane / LPR;            // row of the lane within a load
  const int d0 = (lane % LPR) * EPL;
  const bool lane_ok = d0 < D;

  float qf[kG][EPL];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const uint4* src = reinterpret_cast<const uint4*>(
        q + ((int64_t)b * H + head0 + g) * D + d0);
#pragma unroll
    for (int c = 0; c < EPL / 8; ++c) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (lane_ok && (!kTail || g < nh)) raw = src[c];
      Elem<__nv_bfloat16>::cvt(raw, &qf[g][8 * c]);
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[g][e] *= qk_scale;
  }

  int n_tok = seq_lens[b];
  const int cap = max_pages * page;
  n_tok = n_tok < 0 ? 0 : (n_tok > cap ? cap : n_tok);
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  const int per = (n_tiles + splits - 1) / splits;
  const int j0 = split * per;
  const int j1 = min(n_tiles, j0 + per);
  // distance between consecutive tokens' rows of this head
  const int64_t tok_stride = kPair ? (int64_t)D : (int64_t)2 * KH * D;
  const int* table = tables + (int64_t)b * max_pages;

  uint4* wbuf = smem + warp * 2 * (2 * kChunks);
  auto issue = [&](int tile, int stage) {
    uint4* kd = wbuf + stage * 2 * kChunks;
    uint4* vd = kd + kChunks;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = tile * kTile + i * RPL + r_in;
      const bool ok = lane_ok && t < n_tok;
      const T* ksrc = kp;
      const T* vsrc = kPair ? vp : kp;
      if (ok) {
        const int pi = t / page;
        const int64_t page_id = table[pi];
        const int off = t - pi * page;
        if (kPair) {
          const int64_t row =
              ((((int64_t)layer * KH + kvh) * P + page_id) * page + off) * D +
              d0;
          ksrc = kp + row;
          vsrc = vp + row;
        } else {
          const int64_t row =
              (((int64_t)layer * P + page_id) * page + off) * tok_stride +
              (int64_t)(2 * kvh) * D + d0;
          ksrc = kp + row;
          vsrc = kp + row + D;
        }
      }
      cp_async16(kd + i * 32 + lane, ksrc, ok);
      cp_async16(vd + i * 32 + lane, vsrc, ok);
    }
    cp_async_commit();
  };

  float m[kG], l[kG], acc[kG][EPL];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  int stage = 0;
  if (j0 + warp < j1) issue(j0 + warp, 0);
  for (int tile = j0 + warp; tile < j1; tile += kWarps) {
    if (tile + kWarps < j1) {
      issue(tile + kWarps, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const uint4* kd = wbuf + stage * 2 * kChunks;
    const uint4* vd = kd + kChunks;

    float s[NL][kG];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float kf[EPL];
      Elem<T>::cvt(kd[i * 32 + lane], kf);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qf[g][e], kf[e], a);
        s[i][g] = a;
      }
    }
    // each row's sum over its lane group; then mask tokens past seq_len
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const bool valid = tile * kTile + i * RPL + r_in < n_tok;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          s[i][g] += __shfl_xor_sync(0xffffffffu, s[i][g], o);
        if (!valid) s[i][g] = -INFINITY;
      }
    }
    // online softmax, once per tile and head (a tile holds >= 1 valid token)
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int i = 1; i < NL; ++i) mx = fmaxf(mx, s[i][g]);
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = fast_exp2(m[g] - m_new);  // 0 on the first tile
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        s[i][g] = fast_exp2(s[i][g] - m_new);
        ps += s[i][g];
      }
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float vf[EPL];
      Elem<T>::cvt(vd[i * 32 + lane], vf);
#pragma unroll
      for (int g = 0; g < kG; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(s[i][g], vf[e],
                                                       acc[g][e]);
    }
    stage ^= 1;
  }
  // the lane groups of a warp hold the same dims of different rows
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
#pragma unroll
      for (int o = LPR; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);

  // merge the warps' states in shared memory (the staging slots are free)
  __syncthreads();
  float* sm_m = reinterpret_cast<float*>(smem);
  float* sm_l = sm_m + kWarps * kG;
  float* sm_acc = sm_l + kWarps * kG;  // [kWarps][kG][kMaxD]
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      sm_m[warp * kG + g] = m[g];
      sm_l[warp * kG + g] = l[g];
    }
  }
  if (r_in == 0 && lane_ok) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[(warp * kG + g) * kMaxD + d0 + e] = acc[g][e];
  }
  __syncthreads();

  const int64_t bh = (int64_t)b * gridDim.y + hy;
  const int64_t cta = bh * splits + split;
  float* pm = part;                               // [cta][kG]
  float* pl = part + (int64_t)gridDim.x * gridDim.y * splits * kG;
  float* pacc = pl + (int64_t)gridDim.x * gridDim.y * splits * kG;
  for (int idx = threadIdx.x; idx < nh * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * kG + g]);
    float L = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = sm_m[w * kG + g];
        if (mw != -INFINITY) {
          const float c = fast_exp2(mw - mx);
          L += sm_l[w * kG + g] * c;
          o += sm_acc[(w * kG + g) * kMaxD + d] * c;
        }
      }
    }
    if (splits == 1) {
      const float res = L > 0.f ? o / L * v_scale : 0.f;
      out[((int64_t)b * H + head0 + g) * D + d] = __float2bfloat16(res);
    } else {
      pacc[(cta * kG + g) * D + d] = o;
      if (d == 0) {
        pm[cta * kG + g] = mx;
        pl[cta * kG + g] = L;
      }
    }
  }
  if (splits == 1) return;

  // the last CTA of this (sequence, head group) merges the splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&counters[bh], 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < nh * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
    for (int sp = 0; sp < splits; ++sp)
      mx = fmaxf(mx, __ldcg(pm + (bh * splits + sp) * kG + g));
    float L = 0.f, o = 0.f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < splits; ++sp) {
        const int64_t c = (bh * splits + sp) * kG + g;
        const float ms = __ldcg(pm + c);
        if (ms != -INFINITY) {
          const float w = fast_exp2(ms - mx);
          L += __ldcg(pl + c) * w;
          o += __ldcg(pacc + c * D + d) * w;
        }
      }
    }
    const float res = L > 0.f ? o / L * v_scale : 0.f;
    out[((int64_t)b * H + head0 + g) * D + d] = __float2bfloat16(res);
  }
  if (threadIdx.x == 0) counters[bh] = 0;  // ready for the next launch
}

template <typename T, bool kPair, int kG, bool kTail>
int launch_g(const void* q, const void* kp, const void* vp,
             const void* tables, const void* seq_lens, void* out, void* part,
             void* counters, int B, int H, int KH, int D, int P, int page,
             int max_pages, int layer, float qk_scale, float v_scale,
             int splits, void* stream) {
  constexpr int bytes = smem_bytes<T>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, kPair, kG, kTail>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(B, KH * ((H / KH + kG - 1) / kG), splits);
  paged_decode_kernel<T, kPair, kG, kTail><<<grid, kThreads, bytes,
                                             (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)kp, (const T*)vp,
      (const int*)tables, (const int*)seq_lens, (__nv_bfloat16*)out,
      (float*)part, (int*)counters, H, KH, D, P, page, max_pages, layer,
      qk_scale, v_scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kPair>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* seq_lens, void* out, void* part, void* counters,
           int B, int H, int KH, int D, int P, int page, int max_pages,
           int layer, float qk_scale, float v_scale, int splits,
           void* stream) {
  if (B == 0) return 0;
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && !part)) return -1;
  const int G = H / KH;
  if (G < 1) return -1;
  const int kg = G < kMaxHeads ? G : kMaxHeads;
  qk_scale *= kLog2e;  // the kernel's softmax is in base 2
#define VOX_LAUNCH(N, TAIL)                                                  \
  return launch_g<T, kPair, N, TAIL>(q, kp, vp, tables, seq_lens, out, part, \
                                     counters, B, H, KH, D, P, page,         \
                                     max_pages, layer, qk_scale, v_scale,    \
                                     splits, stream)
  switch (kg) {
    case 1: VOX_LAUNCH(1, false);
    case 2: VOX_LAUNCH(2, false);
    case 3: VOX_LAUNCH(3, false);
    case 4:
      if (G % 4) VOX_LAUNCH(4, true);
      VOX_LAUNCH(4, false);
    default: return -1;
  }
#undef VOX_LAUNCH
}

}  // namespace

// Plain C entries, loaded with ctypes. Each returns cudaGetLastError() after
// the launch (0 = success); -1 for an unknown pool type, head group or split
// count. All pointers are device pointers; `stream` is a cudaStream_t.
// `part` holds splits > 1 partial states: 2 * n + n * D floats for
// n = B * KH * ceil(G / min(G, 4)) * splits * min(G, 4); `counters` holds
// B * KH * ceil(G / min(G, 4)) int32 zeros, and the kernel leaves them zero.

// Combined pool (K1 / K1q). pool_type: 0 bf16, 1 int8, 2 float8 e4m3.
extern "C" int vox_paged_decode_attention(
    const void* q, const void* pool, const void* tables, const void* seq_lens,
    void* out, void* part, void* counters, int B, int H, int KH, int D, int P,
    int page, int max_pages, int layer, float scale, int pool_type,
    float k_scale, float v_scale, int splits, void* stream) {
  const float qk = scale * k_scale;
  switch (pool_type) {
    case 0:
      return launch<__nv_bfloat16, false>(q, pool, pool, tables, seq_lens,
                                          out, part, counters, B, H, KH, D, P,
                                          page, max_pages, layer, qk, v_scale,
                                          splits, stream);
    case 1:
      return launch<int8_t, false>(q, pool, pool, tables, seq_lens, out, part,
                                   counters, B, H, KH, D, P, page, max_pages,
                                   layer, qk, v_scale, splits, stream);
    case 2:
      return launch<__nv_fp8_e4m3, false>(q, pool, pool, tables, seq_lens,
                                          out, part, counters, B, H, KH, D, P,
                                          page, max_pages, layer, qk, v_scale,
                                          splits, stream);
    default:
      return -1;
  }
}

// Head-major bf16 pair (K4).
extern "C" int vox_paged_decode_attention_pair(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* seq_lens, void* out, void* part,
    void* counters, int B, int H, int KH, int D, int P, int page,
    int max_pages, int layer, float scale, int splits, void* stream) {
  return launch<__nv_bfloat16, true>(q, k_pages, v_pages, tables, seq_lens,
                                     out, part, counters, B, H, KH, D, P,
                                     page, max_pages, layer, scale, 1.f,
                                     splits, stream);
}
