// K3: ragged (segment-masked) causal prefill attention, for Hopper (sm_90a).
//
// Replaces vox_serve_tpu/ops/pallas_prefill.py `_pallas_prefill_call`
// (kernel `_prefill_kernel`, wrapper `pallas_ragged_prefill`). Prompts are
// packed token-wise into one T-token buffer with segment ids; token i
// attends token j iff seg[i] == seg[j] >= 0 and j <= i in buffer order
// (segments are contiguous spans, so buffer order is causal order). Rows
// with seg < 0 are padding and their output is not defined by the contract;
// this kernel writes zeros there.
//
// What bounds it on an H100: at prompt lengths of tens to hundreds of
// tokens, the work is small and latency-bound (one launch per talker layer);
// at T ~ 1k the QK^T and PV products dominate. This first version computes
// in f32 on the CUDA cores; wgmma/TMA tiling comes in a later PR.
//
// Design:
//   * one CTA per (query tile, KV head), covering all G query heads of the
//     head's group: the CTA owns 32 query rows = G heads x (32/G) tokens, so
//     each K/V tile it stages serves all G heads;
//   * the key loop runs only over [start of the first valid row's segment,
//     last valid row + 1): causal and ragged skipping in one bound, computed
//     by the CTA from the segment ids, so a short prompt in a long buffer
//     pays for its own tokens only and no host-side valid length is needed;
//   * K/V tiles of 32 keys are staged in shared memory as bf16 (K rows
//     padded by one word so lane j reading key j is bank-conflict free);
//     lane j scores key j, the warp keeps an online f32 softmax per row, and
//     lanes own output dims for the PV product (probabilities broadcast by
//     shuffle);
//   * any T is accepted: the ragged edge is masked, there is no multiple-of-
//     128 rule as in the Pallas kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                        // keys per tile (= lanes)
constexpr int kMaxD = 128;
constexpr int kWords = kMaxD / 2;              // bf16 pairs per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
ragged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ seg,
                      __nv_bfloat16* __restrict__ out,
                      int T, int H, int KH, int D, float scale) {
  const int G = H / KH;
  const int BQ = kRows / G;          // query tokens per CTA
  const int t0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwords = D / 2;

  __shared__ float qs[kRows][kMaxD];
  __shared__ __nv_bfloat162 ks[kBK][kWords + 1];
  __shared__ __nv_bfloat162 vs[kBK][kWords];
  __shared__ int segk[kBK];
  __shared__ int s_first, s_hi, s_lo;

  if (threadIdx.x == 0) {
    s_first = INT_MAX;
    s_hi = 0;
    s_lo = INT_MAX;
  }
  __syncthreads();
  if (threadIdx.x < BQ) {
    const int t = t0 + threadIdx.x;
    if (t < T && seg[t] >= 0) {
      atomicMin(&s_first, t);
      atomicMax(&s_hi, t + 1);
    }
  }
  // stage the CTA's query rows (row r: head g = r / BQ, token t0 + r % BQ)
  for (int idx = threadIdx.x; idx < kRows * nwords; idx += blockDim.x) {
    const int r = idx / nwords;
    const int w = idx - r * nwords;
    const int t = t0 + r % BQ;
    const int g = r / BQ;
    float2 f = make_float2(0.f, 0.f);
    if (t < T) {
      const __nv_bfloat162 pair = reinterpret_cast<const __nv_bfloat162*>(
          q + ((int64_t)t * H + (int64_t)h * G + g) * D)[w];
      f = __bfloat1622float2(pair);
    }
    qs[r][2 * w] = f.x * scale;
    qs[r][2 * w + 1] = f.y * scale;
  }
  __syncthreads();
  const int first = s_first;
  const int hi = s_hi;
  if (first != INT_MAX) {
    // segments are contiguous: the first valid row's segment starts at the
    // smallest index carrying its id
    const int sid = seg[first];
    for (int j = threadIdx.x; j <= first; j += blockDim.x)
      if (seg[j] == sid) atomicMin(&s_lo, j);
  }
  __syncthreads();
  const int lo = (first == INT_MAX) ? hi : (s_lo / kBK) * kBK;

  // per-row state: rows warp*8 .. warp*8+7
  int row_t[kRowsPerWarp], row_seg[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][4];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    row_t[rr] = t0 + r % BQ;
    row_seg[rr] = row_t[rr] < T ? seg[row_t[rr]] : -1;
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[rr][c] = 0.f;
  }

  for (int kt = lo; kt < hi; kt += kBK) {
    // stage 32 keys of K and V for KV head h (4-byte pairs; the padded K
    // row stride is not 8-byte aligned)
    for (int idx = threadIdx.x; idx < kBK * nwords; idx += blockDim.x) {
      const int j = idx / nwords;
      const int w = idx - j * nwords;
      const int t = kt + j;
      __nv_bfloat162 kp = __float2bfloat162_rn(0.f), vp = kp;
      if (t < T) {
        const int64_t off = ((int64_t)t * KH + h) * D;
        kp = reinterpret_cast<const __nv_bfloat162*>(k + off)[w];
        vp = reinterpret_cast<const __nv_bfloat162*>(v + off)[w];
      }
      ks[j][w] = kp;
      vs[j][w] = vp;
    }
    if (threadIdx.x < kBK) {
      const int t = kt + threadIdx.x;
      segk[threadIdx.x] = t < T ? seg[t] : -2;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int sq = row_seg[rr];
      const int tq = row_t[rr];
      if (sq < 0 || kt > tq) continue;  // warp-uniform
      const int r = warp * kRowsPerWarp + rr;
      const int kj = kt + lane;
      float s = -INFINITY;
      if (kj <= tq && segk[lane] == sq) {
        float a = 0.f;
        for (int w = 0; w < nwords; ++w) {
          const float2 kf = __bfloat1622float2(ks[lane][w]);
          a += qs[r][2 * w] * kf.x + qs[r][2 * w + 1] * kf.y;
        }
        s = a;
      }
      const float mt = warp_max(s);
      if (mt == -INFINITY) continue;  // no key of this tile is visible
      const float m_new = fmaxf(m[rr], mt);
      const float p = expf(s - m_new);            // 0 for masked keys
      const float alpha = expf(m[rr] - m_new);    // 0 on the first tile
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int w = lane + 32 * c;  // lane owns dims 2w, 2w+1
        float ax = acc[rr][2 * c] * alpha, ay = acc[rr][2 * c + 1] * alpha;
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          if (w < nwords) {
            const float2 vf = __bfloat1622float2(vs[j][w]);
            ax += pj * vf.x;
            ay += pj * vf.y;
          }
        }
        acc[rr][2 * c] = ax;
        acc[rr][2 * c + 1] = ay;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int t = row_t[rr];
    if (t >= T) continue;
    const int g = r / BQ;
    const float inv = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
        out + ((int64_t)t * H + (int64_t)h * G + g) * D);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int w = lane + 32 * c;
      if (w < nwords)
        o[w] = __floats2bfloat162_rn(acc[rr][2 * c] * inv,
                                     acc[rr][2 * c + 1] * inv);
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int vox_ragged_prefill_attention(
    const void* q, const void* k, const void* v, const void* seg, void* out,
    int T, int H, int KH, int D, float scale, void* stream) {
  if (T == 0) return 0;
  const int G = H / KH;
  const int BQ = kRows / G;
  dim3 grid((T + BQ - 1) / BQ, KH);
  ragged_prefill_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)seg, (__nv_bfloat16*)out,
      T, H, KH, D, scale);
  return (int)cudaGetLastError();
}
