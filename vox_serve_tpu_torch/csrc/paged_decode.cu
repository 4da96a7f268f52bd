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
// What bounds it on an H100: bytes. Every K/V element is read once and used
// for 2*G flops (G = 2 for Qwen3-TTS), far below the ~295 flop/byte ridge,
// so the kernel is a stream over the live pages of each sequence. A 1-byte
// pool halves the bytes of a bf16 one.
//
// Design:
//   * one CTA per (sequence, KV head), holding the G query heads of that
//     group, so each K/V row read from device memory serves all G heads;
//   * four warps split the sequence's pages round-robin; a warp walks only
//     ceil(seq_len / page) block-table entries, never the table's width;
//     each lane holds D/32 contiguous dims of q, K and V (one 8-byte load
//     per row per lane for bf16, one 4-byte load for 1-byte types; a warp
//     reads one K row coalesced);
//   * scores and softmax are online in f32 per warp; the warps' partial
//     (max, sum, acc) states merge in shared memory at the end;
//   * pool offsets are computed in 64 bits: the flagship pool with P=4096
//     holds 28*4096*16*16*128 ~ 3.8e9 elements, past int32;
//   * seq_len == 0 gives a zero output (padded batch rows use seq_len 1 on
//     scratch page 0, so serving never sends 0).
// Known limit: at B=1 only KH (8 for the flagship) CTAs run on 132 SMs; a
// split over the sequence (split-KV) comes later, as do TMA and wgmma.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxG = 8;      // query heads per KV head
constexpr int kMaxD = 128;    // head dim; 4 elements per lane
constexpr int kPerLane = kMaxD / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive elements -> f32 (zeros for an idle lane)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool ok,
                                      float out[kPerLane]) {
  if (ok) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 fa = __bfloat1622float2(a);
    float2 fb = __bfloat1622float2(b);
    out[0] = fa.x; out[1] = fa.y; out[2] = fb.x; out[3] = fb.y;
  } else {
    out[0] = out[1] = out[2] = out[3] = 0.f;
  }
}

__device__ __forceinline__ void load4(const int8_t* p, bool ok,
                                      float out[kPerLane]) {
  if (ok) {
    char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
    out[0] = out[1] = out[2] = out[3] = 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_fp8_e4m3* p, bool ok,
                                      float out[kPerLane]) {
  if (ok) {
    float4 f = static_cast<float4>(
        *reinterpret_cast<const __nv_fp8x4_e4m3*>(p));
    out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
  } else {
    out[0] = out[1] = out[2] = out[3] = 0.f;
  }
}

// kPair = false: `kp` is the combined pool and `vp` is unused.
// kPair = true: `kp` and `vp` are the head-major K and V pools.
template <typename T, bool kPair>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out,
                    int H, int KH, int D, int P, int page, int max_pages,
                    int layer, float qk_scale, float v_scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / KH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * kPerLane;
  const bool lane_ok = d0 < D;

  __shared__ float sm_m[kWarps][kMaxG];
  __shared__ float sm_l[kWarps][kMaxG];
  __shared__ float sm_acc[kWarps][kMaxG][kMaxD];

  float qv[kMaxG][kPerLane];
  float m[kMaxG], l[kMaxG], acc[kMaxG][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[g][e] = 0.f;
    if (g < G) {
      const int64_t qoff = ((int64_t)b * H + (int64_t)h * G + g) * D + d0;
      load4(q + qoff, lane_ok, qv[g]);
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) qv[g][e] *= qk_scale;
    } else {
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) qv[g][e] = 0.f;
    }
  }

  int n_tok = seq_lens[b];
  const int cap = max_pages * page;
  n_tok = n_tok < 0 ? 0 : (n_tok > cap ? cap : n_tok);
  const int n_pages = (n_tok + page - 1) / page;
  // distance between consecutive tokens' rows of this head
  const int64_t tok_stride = kPair ? (int64_t)D : (int64_t)2 * KH * D;

  for (int pi = warp; pi < n_pages; pi += kWarps) {
    const int64_t page_id = tables[(int64_t)b * max_pages + pi];
    const T* krow;
    const T* vrow;
    if (kPair) {
      const int64_t off = (((int64_t)layer * KH + h) * P + page_id) * page * D;
      krow = kp + off + d0;
      vrow = vp + off + d0;
    } else {
      const int64_t off = ((int64_t)layer * P + page_id) * page * tok_stride;
      krow = kp + off + (int64_t)(2 * h) * D + d0;
      vrow = krow + D;
    }
    const int t_end = min(page, n_tok - pi * page);
    for (int t = 0; t < t_end; ++t) {
      float kf[kPerLane], vf[kPerLane];
      load4(krow + t * tok_stride, lane_ok, kf);
      load4(vrow + t * tok_stride, lane_ok, vf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) s += qv[g][e] * kf[e];
          s = warp_sum(s);
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);  // exp(-inf) = 0 at start
          const float p = expf(s - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e)
            acc[g][e] = acc[g][e] * alpha + p * vf[e];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (sm_m[w][g] != -INFINITY) {
          const float c = expf(sm_m[w][g] - mx);
          L += sm_l[w][g] * c;
          o += sm_acc[w][g][d] * c;
        }
      }
    }
    const float res = L > 0.f ? o / L * v_scale : 0.f;
    out[((int64_t)b * H + (int64_t)h * G + g) * D + d] = __float2bfloat16(res);
  }
}

template <typename T, bool kPair>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* seq_lens, void* out, int B, int H, int KH, int D, int P,
           int page, int max_pages, int layer, float qk_scale, float v_scale,
           void* stream) {
  if (B == 0) return 0;
  dim3 grid(B, KH);
  paged_decode_kernel<T, kPair><<<grid, kWarps * 32, 0,
                                  (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)kp, (const T*)vp,
      (const int*)tables, (const int*)seq_lens, (__nv_bfloat16*)out, H, KH,
      D, P, page, max_pages, layer, qk_scale, v_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries, loaded with ctypes. Each returns cudaGetLastError() after
// the launch (0 = success); -1 for an unknown pool type. All pointers are
// device pointers; `stream` is a cudaStream_t.

// Combined pool (K1 / K1q). pool_type: 0 bf16, 1 int8, 2 float8 e4m3.
extern "C" int vox_paged_decode_attention(
    const void* q, const void* pool, const void* tables, const void* seq_lens,
    void* out, int B, int H, int KH, int D, int P, int page, int max_pages,
    int layer, float scale, int pool_type, float k_scale, float v_scale,
    void* stream) {
  const float qk = scale * k_scale;
  switch (pool_type) {
    case 0:
      return launch<__nv_bfloat16, false>(q, pool, pool, tables, seq_lens,
                                          out, B, H, KH, D, P, page,
                                          max_pages, layer, qk, v_scale,
                                          stream);
    case 1:
      return launch<int8_t, false>(q, pool, pool, tables, seq_lens, out, B,
                                   H, KH, D, P, page, max_pages, layer, qk,
                                   v_scale, stream);
    case 2:
      return launch<__nv_fp8_e4m3, false>(q, pool, pool, tables, seq_lens,
                                          out, B, H, KH, D, P, page,
                                          max_pages, layer, qk, v_scale,
                                          stream);
    default:
      return -1;
  }
}

// Head-major bf16 pair (K4).
extern "C" int vox_paged_decode_attention_pair(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* seq_lens, void* out, int B, int H, int KH,
    int D, int P, int page, int max_pages, int layer, float scale,
    void* stream) {
  return launch<__nv_bfloat16, true>(q, k_pages, v_pages, tables, seq_lens,
                                     out, B, H, KH, D, P, page, max_pages,
                                     layer, scale, 1.f, stream);
}
