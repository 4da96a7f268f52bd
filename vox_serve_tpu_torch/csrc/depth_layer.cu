// K6: the layer of the depth transformer ("code predictor") around its four
// projections, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: vox_serve_tpu/models/depth.py `depth_forward`
// leaves this chain to XLA, which fuses it inside the jitted codebook loop.
// Run op by op in PyTorch it is ~85 launches a layer (each RMS norm 11, the
// rotary ~8 per tensor, a float32 copy of the whole cache per layer), and
// Qwen3-TTS runs 75 such layers a frame. Four kernels take that chain; the
// q|k|v, o, gate|up and down projections stay plain matrix products:
//
//   K6a depth_add_rms_norm  h' = bf16(h + r), out = bf16(rms_norm(h') * w):
//       the input norm (r: the previous layer's down projection), the
//       post-attention norm (r: the o projection) and the final norm;
//   K6b depth_qkv_rope      over the q|k|v product: q/k RMS norm (Qwen3's
//       qk_norm), the split-half rotary at start_pos + i, k and v into the
//       dense (B, max_seq, KH, D) cache of the layer, q out;
//   K6c depth_attention     one CTA per (row, KV head): the G query heads of
//       the t <= 2 new tokens against the cache rows they see, read straight
//       from the bf16 cache; scores, the causal mask, softmax and P.V in f32;
//   K6d depth_silu_mul      gate|up -> silu(g) * u.
//
// What bounds them on an H100: bytes, far below the card at these sizes
// (a Qwen3 decode at B = 128: 256 KB a norm, 1 MB of q|k|v, <= 1.1 MB of
// cache, 1.5 MB of gate|up), so each is a few microseconds, most of it the
// launch and one trip to memory; the gain is the ~80 launches a layer and
// the float32 intermediates (the cache copies above all) that no longer
// exist. Design: one CTA per row for the norms and the rotary (16-byte
// loads, warp-shuffle sums), one per (row, KV head) for attention with its
// cache rows staged in shared memory (row stride 65 words, so threads on
// consecutive keys read distinct banks), a grid-stride loop for SiLU.
//
// Rounding follows the plain versions (ops/kernels.py *_plain) point by
// point: the bf16 sum before the norm's statistics, the norm's bf16 output
// before the rotary, the rotary's one cast, silu's bf16 output before the
// product. Products and sums that PyTorch rounds one at a time use the _rn
// intrinsics, so nvcc does not contract them into FMAs; rsqrtf, powf,
// cosf, sinf and expf are the functions PyTorch's own kernels call. Sums
// over a row run in another order than PyTorch's reductions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kVec = 8;            // bf16 per 16-byte load
constexpr int kHeadDim = 128;      // K6b and K6c
constexpr int kMaxSeq = 64;        // cache positions K6c stages
constexpr int kMaxQueries = 16;    // G * t query rows of one K6c CTA
constexpr int kRow = kHeadDim + 2; // staged K/V row stride: 65 words
constexpr int kQRow = kHeadDim + 1;
constexpr int kNormMaxThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const bf162* p = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  bf162* p = reinterpret_cast<bf162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- K6a ------------------------------------------------------------------
// One CTA per row, one 8-wide chunk a thread (C / 8 threads, rounded up to
// whole warps). r == nullptr: no residual add, h_out is not written.
__global__ void add_rms_norm_kernel(const bf16* __restrict__ h,
                                    const bf16* __restrict__ r,
                                    const bf16* __restrict__ w,
                                    bf16* __restrict__ h_out,
                                    bf16* __restrict__ out, int C, float eps,
                                    float inv_c) {
  __shared__ float red[kNormMaxThreads / 32];
  const int c0 = threadIdx.x * kVec;
  const bool on = c0 < C;
  const size_t off = (size_t)blockIdx.x * C + c0;
  float x[kVec];
  float ss = 0.f;
  if (on) {
    unpack8(*reinterpret_cast<const uint4*>(h + off), x);
    if (r != nullptr) {
      float y[kVec];
      unpack8(*reinterpret_cast<const uint4*>(r + off), y);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = __fadd_rn(x[i], y[i]);
      const uint4 s = pack8(x);
      *reinterpret_cast<uint4*>(h_out + off) = s;
      unpack8(s, x);  // the statistics see the bf16 sum, as the plain add
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) ss = __fadd_rn(ss, __fmul_rn(x[i], x[i]));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  if (!on) return;
  const float rinv = rsqrtf(__fadd_rn(__fmul_rn(red[0], inv_c), eps));
  float wf[kVec];
  unpack8(*reinterpret_cast<const uint4*>(w + c0), wf);
#pragma unroll
  for (int i = 0; i < kVec; ++i) x[i] = __fmul_rn(__fmul_rn(x[i], rinv), wf[i]);
  *reinterpret_cast<uint4*>(out + off) = pack8(x);
}

// ---- K6b ------------------------------------------------------------------
// One CTA per row (b, i) of the q|k|v product, a warp per head; lane l holds
// dims 2l, 2l + 1 and their rotary partners 64 + 2l, 64 + 2l + 1.
__global__ void qkv_rope_kernel(const bf16* __restrict__ qkv,
                                const bf16* __restrict__ q_norm,
                                const bf16* __restrict__ k_norm,
                                bf16* __restrict__ q_out,
                                bf16* __restrict__ kc,
                                bf16* __restrict__ vc, int t, int H, int KH,
                                int S, int start_pos, float theta,
                                float eps) {
  constexpr int D = kHeadDim, half = D / 2;
  const int row = blockIdx.x, b = row / t;
  const int pos = start_pos + (row - b * t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = 2 * lane;
  // rope_frequencies: 1 / theta ** (2i / D), then the angle pos * inv_freq
  float cs[2], sn[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float e = __fdiv_rn((float)(2 * (d0 + p)), (float)D);
    const float ang = __fmul_rn((float)pos, __fdiv_rn(1.f, powf(theta, e)));
    cs[p] = cosf(ang);
    sn[p] = sinf(ang);
  }
  const int heads = H + 2 * KH;
  const bf16* src = qkv + (size_t)row * heads * D;
  for (int hd = warp; hd < heads; hd += blockDim.x >> 5) {
    const bf162 lo = *reinterpret_cast<const bf162*>(src + hd * D + d0);
    const bf162 hi = *reinterpret_cast<const bf162*>(src + hd * D + half + d0);
    if (hd >= H + KH) {  // v: into the cache as it is
      bf16* dst = vc + (((size_t)b * S + pos) * KH + (hd - H - KH)) * D;
      *reinterpret_cast<bf162*>(dst + d0) = lo;
      *reinterpret_cast<bf162*>(dst + half + d0) = hi;
      continue;
    }
    const float2 a = __bfloat1622float2(lo), c = __bfloat1622float2(hi);
    float v[4] = {a.x, a.y, c.x, c.y};
    const bf16* nw = hd < H ? q_norm : k_norm;
    if (nw != nullptr) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) ss = __fadd_rn(ss, __fmul_rn(v[i], v[i]));
      ss = warp_sum(ss);
      const float rinv = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / D), eps));
      const bf162* w2 = reinterpret_cast<const bf162*>(nw);
      const float2 wl = __bfloat1622float2(w2[lane]);
      const float2 wh = __bfloat1622float2(w2[half / 2 + lane]);
      const float wv[4] = {wl.x, wl.y, wh.x, wh.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = round_bf16(__fmul_rn(__fmul_rn(v[i], rinv), wv[i]));
    }
    float o[4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float x1 = v[p], x2 = v[2 + p];
      o[p] = __fsub_rn(__fmul_rn(x1, cs[p]), __fmul_rn(x2, sn[p]));
      o[2 + p] = __fadd_rn(__fmul_rn(x2, cs[p]), __fmul_rn(x1, sn[p]));
    }
    bf16* dst = hd < H ? q_out + ((size_t)row * H + hd) * D
                       : kc + (((size_t)b * S + pos) * KH + (hd - H)) * D;
    *reinterpret_cast<bf162*>(dst + d0) = __floats2bfloat162_rn(o[0], o[1]);
    *reinterpret_cast<bf162*>(dst + half + d0) =
        __floats2bfloat162_rn(o[2], o[3]);
  }
}

// ---- K6c ------------------------------------------------------------------
// One CTA per (row b, KV head): query i * G + g is head kh * G + g of new
// token i at position start_pos + i and sees cache rows 0 .. its position.
// Shared memory: the n = start_pos + t rows of K and V (bf16, stride kRow),
// the Q scaled queries (f32), the Q x n scores.
__global__ void attention_kernel(const bf16* __restrict__ q,
                                 const bf16* __restrict__ kc,
                                 const bf16* __restrict__ vc,
                                 bf16* __restrict__ out, int t, int H, int KH,
                                 int S, int start_pos, float scale) {
  constexpr int D = kHeadDim, words = D / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / KH, Q = G * t, n = start_pos + t;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + n * kRow;
  float* qs = reinterpret_cast<float*>(vs + n * kRow);
  float* ps = qs + Q * kQRow;

  for (int i = threadIdx.x; i < n * (D / kVec); i += blockDim.x) {
    const int j = i / (D / kVec), c = i % (D / kVec);
    const size_t g = (((size_t)b * S + j) * KH + kh) * D + c * kVec;
    const uint4 kv = *reinterpret_cast<const uint4*>(kc + g);
    const uint4 vv = *reinterpret_cast<const uint4*>(vc + g);
    uint32_t* kd = reinterpret_cast<uint32_t*>(ks + j * kRow + c * kVec);
    uint32_t* vd = reinterpret_cast<uint32_t*>(vs + j * kRow + c * kVec);
    kd[0] = kv.x; kd[1] = kv.y; kd[2] = kv.z; kd[3] = kv.w;
    vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
  }
  for (int i = threadIdx.x; i < Q * D; i += blockDim.x) {
    const int qi = i / D, d = i % D, ti = qi / G, g = qi % G;
    const float x = __bfloat162float(
        q[(((size_t)b * t + ti) * H + kh * G + g) * D + d]);
    qs[qi * kQRow + d] = __fmul_rn(x, scale);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Q * n; i += blockDim.x) {
    const int qi = i / n, j = i % n;
    if (j > start_pos + qi / G) continue;  // the causal mask
    const float* qr = qs + qi * kQRow;
    const bf162* kr = reinterpret_cast<const bf162*>(ks + j * kRow);
    float acc = 0.f;
#pragma unroll 8
    for (int w = 0; w < words; ++w) {
      const float2 kk = __bfloat1622float2(kr[w]);
      acc = fmaf(qr[2 * w], kk.x, acc);
      acc = fmaf(qr[2 * w + 1], kk.y, acc);
    }
    ps[qi * n + j] = acc;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int qi = warp; qi < Q; qi += blockDim.x >> 5) {
    const int seen = start_pos + qi / G + 1;
    float* pr = ps + qi * n;
    float m = -INFINITY;
    for (int j = lane; j < seen; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < seen; j += 32) {
      const float e = expf(__fsub_rn(pr[j], m));
      pr[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int j = lane; j < seen; j += 32) pr[j] = __fdiv_rn(pr[j], sum);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < Q * words; i += blockDim.x) {
    const int qi = i / words, w = i % words;
    const int ti = qi / G, g = qi % G, seen = start_pos + ti + 1;
    const float* pr = ps + qi * n;
    float a0 = 0.f, a1 = 0.f;
    for (int j = 0; j < seen; ++j) {
      const float2 vv = __bfloat1622float2(
          reinterpret_cast<const bf162*>(vs + j * kRow)[w]);
      a0 = fmaf(pr[j], vv.x, a0);
      a1 = fmaf(pr[j], vv.y, a1);
    }
    *reinterpret_cast<bf162*>(
        out + (((size_t)b * t + ti) * H + kh * G + g) * D + 2 * w) =
        __floats2bfloat162_rn(a0, a1);
  }
}

// ---- K6d ------------------------------------------------------------------
__global__ void silu_mul_kernel(const bf16* __restrict__ gu,
                                bf16* __restrict__ out, int N, int I) {
  const int per_row = I / kVec;
  const long long total = (long long)N * per_row;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / per_row;
    const int c = (int)(i - row * per_row) * kVec;
    float g[kVec], u[kVec];
    unpack8(*reinterpret_cast<const uint4*>(gu + row * 2 * I + c), g);
    unpack8(*reinterpret_cast<const uint4*>(gu + row * 2 * I + I + c), u);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float s = round_bf16(__fdiv_rn(g[k], __fadd_rn(1.f, expf(-g[k]))));
      g[k] = __fmul_rn(s, u[k]);
    }
    *reinterpret_cast<uint4*>(out + row * I + c) = pack8(g);
  }
}

}  // namespace

// Plain C entries, loaded with ctypes from ops/kernels.py, which checks
// every shape, type and layout first. Each returns cudaGetLastError() after
// its launch (0 = success), or -1 for a shape it does not take.

// h, r (nullptr: none), h_out, out: (N, C) bf16; w: (C,) bf16.
extern "C" int vox_depth_add_rms_norm(const void* h, const void* r,
                                      const void* w, void* h_out, void* out,
                                      int N, int C, float eps,
                                      void* stream) {
  if (C <= 0 || C % kVec || C / kVec > kNormMaxThreads) return -1;
  if (N == 0) return 0;
  const int threads = (C / kVec + 31) / 32 * 32;
  add_rms_norm_kernel<<<N, threads, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, (const bf16*)r, (const bf16*)w, (bf16*)h_out,
      (bf16*)out, C, eps, 1.f / (float)C);
  return (int)cudaGetLastError();
}

// qkv: (B * t, (H + 2 KH) * 128) bf16; q_norm, k_norm: (128,) bf16 or both
// nullptr; q_out: (B * t, H * 128); k_cache, v_cache: one layer's (B, S,
// KH, 128), written at positions start_pos .. start_pos + t - 1.
extern "C" int vox_depth_qkv_rope(const void* qkv, const void* q_norm,
                                  const void* k_norm, void* q_out,
                                  void* k_cache, void* v_cache, int B, int t,
                                  int H, int KH, int D, int S, int start_pos,
                                  float theta, float eps, void* stream) {
  if (D != kHeadDim || t < 1 || KH < 1 || H < 1 || start_pos < 0 ||
      start_pos + t > S)
    return -1;
  if (B == 0) return 0;
  qkv_rope_kernel<<<B * t, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const bf16*)q_norm, (const bf16*)k_norm,
      (bf16*)q_out, (bf16*)k_cache, (bf16*)v_cache, t, H, KH, S, start_pos,
      theta, eps);
  return (int)cudaGetLastError();
}

// q: (B * t, H * 128) bf16; k_cache, v_cache: one layer's (B, S, KH, 128);
// out: (B * t, H * 128) bf16.
extern "C" int vox_depth_attention(const void* q, const void* k_cache,
                                   const void* v_cache, void* out, int B,
                                   int t, int H, int KH, int D, int S,
                                   int start_pos, float scale,
                                   void* stream) {
  if (D != kHeadDim || t < 1 || KH < 1 || H % KH || start_pos < 0 ||
      start_pos + t > S || S > kMaxSeq || (H / KH) * t > kMaxQueries)
    return -1;
  if (B == 0) return 0;
  const int n = start_pos + t, Q = (H / KH) * t;
  const size_t bytes = (size_t)2 * n * kRow * sizeof(bf16) +
                       (size_t)Q * kQRow * sizeof(float) +
                       (size_t)Q * n * sizeof(float);
  attention_kernel<<<dim3(B, KH), 128, bytes, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k_cache, (const bf16*)v_cache,
      (bf16*)out, t, H, KH, S, start_pos, scale);
  return (int)cudaGetLastError();
}

// gu: (N, 2 I) bf16, gate then up; out: (N, I) bf16.
extern "C" int vox_depth_silu_mul(const void* gu, void* out, int N, int I,
                                  int n_sm, void* stream) {
  if (I <= 0 || I % kVec) return -1;
  if (N == 0) return 0;
  const long long chunks = (long long)N * (I / kVec);
  const long long want = (chunks + 255) / 256;
  const int blocks = (int)(want < 8LL * n_sm ? want : 8LL * n_sm);
  silu_mul_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)gu, (bf16*)out, N, I);
  return (int)cudaGetLastError();
}
