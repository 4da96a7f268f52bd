// K2: one residual unit of the Qwen3 codec decoder, for Hopper (sm_90a).
//
// Replaces vox_serve_tpu/ops/pallas_resunit.py `fused_resunit_stack`
// (kernel `_kernel`), which runs three chained units
//     out = x + conv1x1(snake2(conv_k7,dil(snake1(x)) + b1)) + b2
// with dilations 1, 3, 9 and streaming halos in and out, for one batch row
// per grid step with the whole (T, C) activation in VMEM. snake(x) =
// x + binv * sin(af * x)^2 with af = exp(alpha), binv = 1/(exp(beta)+1e-9).
//
// One launch per unit (three per stack), the activation between units
// going through device memory. Why not the TPU's whole stack in one
// program: a batch row at C=768 does not fit 227 KB of shared memory, and
// even the stack's 78-sample halo across all 768 channels does not fit in
// f32; recomputing halos across a time-tiled single launch would cost more
// than the round trip of the activation through L2/HBM, which is small next
// to the products (see below).
//
// What bounds it on an H100: FMAs. Per snaked sample-channel the unit does
// 7*C FMAs of the dilated conv and C of the 1x1 conv (8*C in all) against
// two sinf, so at C >= 96 it is compute-bound, on CUDA cores in f32 (the
// codec is f32 with TF32 off; no tensor cores here). The design is a
// register-tiled implicit GEMM:
//   * a CTA of 256 threads owns TM time steps of one batch row and ALL C
//     output channels (the 1x1 conv needs every channel of z), walking them
//     in chunks of TN; each thread holds 4 time steps x 4 consecutive
//     channels (one float4 of weights per K step from shared memory);
//   * conv1 as GEMM M=TM, N=TN, K=7*C: per step of 8 input channels the CTA
//     stages the snaked input rows [t0-pad, t0+TM) in shared memory (snake1
//     applied on load; rows before 0 come from the unit's cache, which holds
//     already-snaked samples, or zeros) and the 7 taps' weights, then every
//     tap reads the same input tile shifted by j*dil rows;
//   * staging is double-buffered: the next step's weights stream in with
//     cp.async and its input samples load into registers while the current
//     step computes (staged synchronously, every K step would wait out an
//     L2 round trip per weight);
//   * bias + snake2 in registers, z kept in shared memory (C x TM);
//   * conv2 as GEMM M=TM, N=TN, K=C over z, with bias and the residual add
//     (x re-read from device memory) as the epilogue;
//   * the unit's new cache, the last 6*dil snaked input samples, is written
//     during the first N chunk by the CTA that owns those time steps;
//   * TM = 32 (TN = 128), or TM = 16 (TN = 256) when the grid would
//     otherwise leave SMs idle (the C=768 block has few time steps).
// sinf, not __sinf: snake arguments are not small. No fast-math.
// Known limits: the input operand is read as scalars (5 shared-memory
// wavefronts per 16 FMAs of a warp), __syncthreads twice per K step, no
// tensor cores (3xTF32 would be the route), and the C=768 block has only
// B*T/16 CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 7;
constexpr int kKC = 8;               // input channels per conv1 K step
constexpr int kKC2 = kKC * kTaps;    // input channels per conv2 K step
constexpr int kMaxPad = 54;          // 6 * the largest dilation

__device__ __forceinline__ float snake(float x, float af, float binv) {
  const float s = sinf(x * af);
  return x + binv * (s * s);
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !pred (the source is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int TM>
struct Tile {
  static constexpr int TR = TM / 4;           // thread rows (4 steps each)
  static constexpr int TCN = kThreads / TR;   // thread cols (4 chans each)
  static constexpr int TN = 4 * TCN;          // output channels per chunk
  static constexpr int TMS = TM + 1;          // z row stride (bank spread)
  static constexpr int WS = kTaps * kKC * TN; // floats per weight stage
  static constexpr int WV = WS / 4 / kThreads;  // float4 copies per thread
  static constexpr int XPer = (kKC * (TM + kMaxPad) + kThreads - 1) /
                              kThreads;       // input samples per thread
};

// one K step's weights into `dst`: conv1 rows (tap j, input channel
// ci0 + kc) or conv2 rows (input channel ci0 + r, r < rows); columns
// n0 .. n0+TN (zero past C)
template <int TM, bool kConv2>
__device__ __forceinline__ void stage_weights(float* dst, const float* w,
                                              int C, int ci0, int n0,
                                              int rows) {
  using Tl = Tile<TM>;
  constexpr int NV = Tl::TN / 4;
#pragma unroll
  for (int it = 0; it < Tl::WV; ++it) {
    const int v = threadIdx.x + it * kThreads;
    const int n = 4 * (v % NV);
    const int r = v / NV;                       // j * kKC + kc, or conv2 row
    const int co = n0 + n;
    int64_t src;
    bool ok = co < C;
    if (kConv2) {
      ok = ok && r < rows;
      src = (int64_t)(ci0 + (ok ? r : 0)) * C + (ok ? co : 0);
    } else {
      const int j = r / kKC;
      const int kc = r - j * kKC;
      src = ((int64_t)j * C + ci0 + kc) * C + (ok ? co : 0);
    }
    cp_async16(dst + r * Tl::TN + n, w + src, ok);
  }
  cp_async_commit();
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
resunit_kernel(const float* __restrict__ x, const float* __restrict__ cache,
               const float* __restrict__ w1t, const float* __restrict__ b1,
               const float* __restrict__ w2t, const float* __restrict__ b2,
               const float* __restrict__ af1, const float* __restrict__ bi1,
               const float* __restrict__ af2, const float* __restrict__ bi2,
               float* __restrict__ out, float* __restrict__ ncache, int C,
               int T, int dil) {
  using Tl = Tile<TM>;
  constexpr int TR = Tl::TR, TN = Tl::TN, TMS = Tl::TMS;
  extern __shared__ __align__(16) float smem[];
  const int pad = 6 * dil;
  const int YS = TM + pad;              // staged input rows
  const int YN = kKC * YS;              // floats per input stage
  float* zs = smem;                     // [C][TMS]
  float* ys0 = zs + (size_t)C * TMS;    // two input stages of YN floats
  float* ws0 = ys0 + 2 * YN;            // two weight stages of WS floats
  // (C % 8 == 0 and YN % 4 == 0 keep ws0 16-byte aligned)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tr = lane % TR;
  const int tc = lane / TR + (32 / TR) * (tid >> 5);
  const float* xb = x + (int64_t)b * C * T;
  const float* cb = cache ? cache + (int64_t)b * C * pad : nullptr;
  float* ncb = ncache ? ncache + (int64_t)b * C * pad : nullptr;

  // input samples of one K step: raw loads (issued early), then snake1 and
  // the store into an input stage
  float xr[Tl::XPer];
  auto load_x = [&](int ci0) {
#pragma unroll
    for (int e = 0; e < Tl::XPer; ++e) {
      const int idx = tid + e * kThreads;
      float val = 0.f;
      if (idx < YN) {
        const int kc = idx / YS;
        const int s = t0 - pad + idx - kc * YS;
        const int ci = ci0 + kc;
        if (s < 0) {
          if (cb) val = cb[(int64_t)ci * pad + pad + s];
        } else if (s < T) {
          val = xb[(int64_t)ci * T + s];
        }
      }
      xr[e] = val;
    }
  };
  auto store_x = [&](float* ys, int ci0, bool first_chunk) {
#pragma unroll
    for (int e = 0; e < Tl::XPer; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < YN) {
        const int kc = idx / YS;
        const int s = t0 - pad + idx - kc * YS;
        const int ci = ci0 + kc;
        float val = xr[e];
        if (s >= 0 && s < T) {  // the cache half is already snaked
          val = snake(val, af1[ci], bi1[ci]);
          if (ncb && first_chunk && s >= t0 && s >= T - pad)
            ncb[(int64_t)ci * pad + s - (T - pad)] = val;
        }
        ys[idx] = val;
      }
    }
  };

  // ---- conv1 + b1 + snake2 -> zs, one chunk of TN output channels at a time
  for (int n0 = 0; n0 < C; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    stage_weights<TM, false>(ws0, w1t, C, 0, n0, 0);
    load_x(0);
    store_x(ys0, 0, n0 == 0);
    for (int ci0 = 0, k = 0; ci0 < C; ci0 += kKC, ++k) {
      const int cur = k & 1;
      const bool more = ci0 + kKC < C;
      if (more) {
        stage_weights<TM, false>(ws0 + (cur ^ 1) * Tl::WS, w1t, C,
                                 ci0 + kKC, n0, 0);
        load_x(ci0 + kKC);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ys = ys0 + cur * YN;
      const float* ws = ws0 + cur * Tl::WS;
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          const float* yr = ys + kc * YS + j * dil + tr;
          const float4 w = *reinterpret_cast<const float4*>(
              ws + (j * kKC + kc) * TN + 4 * tc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = yr[TR * i];
            acc[i][0] = fmaf(a, w.x, acc[i][0]);
            acc[i][1] = fmaf(a, w.y, acc[i][1]);
            acc[i][2] = fmaf(a, w.z, acc[i][2]);
            acc[i][3] = fmaf(a, w.w, acc[i][3]);
          }
        }
      }
      if (more) store_x(ys0 + (cur ^ 1) * YN, ci0 + kKC, n0 == 0);
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = n0 + 4 * tc + c;
      if (co < C) {
        const float bias = b1[co], af = af2[co], bi = bi2[co];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          zs[co * TMS + tr + TR * i] = snake(acc[i][c] + bias, af, bi);
      }
    }
  }
  __syncthreads();

  // ---- conv2 (1x1) + b2 + residual -> out
  float* ob = out + (int64_t)b * C * T;
  for (int n0 = 0; n0 < C; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    stage_weights<TM, true>(ws0, w2t, C, 0, n0, min(kKC2, C));
    for (int ci0 = 0, k = 0; ci0 < C; ci0 += kKC2, ++k) {
      const int cur = k & 1;
      const int kn = min(kKC2, C - ci0);   // a multiple of kKC
      const bool more = ci0 + kKC2 < C;
      if (more) {
        stage_weights<TM, true>(ws0 + (cur ^ 1) * Tl::WS, w2t, C,
                                ci0 + kKC2, n0, min(kKC2, C - ci0 - kKC2));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* ws = ws0 + cur * Tl::WS;
      for (int k8 = 0; k8 < kn; k8 += kKC) {
#pragma unroll
        for (int kc = k8; kc < k8 + kKC; ++kc) {
          const float* zr = zs + (ci0 + kc) * TMS + tr;
          const float4 w =
              *reinterpret_cast<const float4*>(ws + kc * TN + 4 * tc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = zr[TR * i];
            acc[i][0] = fmaf(a, w.x, acc[i][0]);
            acc[i][1] = fmaf(a, w.y, acc[i][1]);
            acc[i][2] = fmaf(a, w.z, acc[i][2]);
            acc[i][3] = fmaf(a, w.w, acc[i][3]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int co = n0 + 4 * tc + c;
      if (co < C) {
        const float bias = b2[co];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + tr + TR * i;
          if (t < T) {
            const int64_t o = (int64_t)co * T + t;
            ob[o] = xb[o] + (acc[i][c] + bias);
          }
        }
      }
    }
  }
}

size_t smem_bytes(int C, int dil, int tm) {
  const int tn = 4 * (kThreads / (tm / 4));
  return sizeof(float) * ((size_t)C * (tm + 1) +
                          2 * (size_t)kKC * (tm + 6 * dil) +
                          2 * (size_t)kTaps * kKC * tn);
}

template <int TM>
int launch(const float* x, const float* cache, const float* w1t,
           const float* b1, const float* w2t, const float* b2,
           const float* af1, const float* bi1, const float* af2,
           const float* bi2, float* out, float* ncache, int B, int C, int T,
           int dil, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, dil, TM);
  cudaError_t err = cudaFuncSetAttribute(
      resunit_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TM - 1) / TM, B);
  resunit_kernel<TM><<<grid, kThreads, smem, stream>>>(
      x, cache, w1t, b1, w2t, b2, af1, bi1, af2, bi2, out, ncache, C, T, dil);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes (the wrapper checks it against
// the card's limit before launching).
extern "C" long long vox_resunit_smem_bytes(int C, int dil, int tm) {
  return (long long)smem_bytes(C, dil, tm);
}

// Plain C entry, loaded with ctypes: one residual unit. x, out: (B, C, T);
// cache, ncache: (B, C, 6*dil) or null (zero halo, no new cache); w1t:
// (7, C_in, C_out); w2t: (C_in, C_out); b1, b2, af1, bi1, af2, bi2: (C,).
// All float32 device pointers, contiguous and 16-byte aligned; C % 8 == 0;
// dil <= 9. tm: 16 or 32. Returns cudaGetLastError() after the launch
// (0 = success), -1 for a bad tm.
extern "C" int vox_resunit(const void* x, const void* cache, const void* w1t,
                           const void* b1, const void* w2t, const void* b2,
                           const void* af1, const void* bi1, const void* af2,
                           const void* bi2, void* out, void* ncache, int B,
                           int C, int T, int dil, int tm, void* stream) {
  if (B == 0 || T == 0) return 0;
  auto f = [](const void* p) { return (const float*)p; };
  if (tm == 32)
    return launch<32>(f(x), f(cache), f(w1t), f(b1), f(w2t), f(b2), f(af1),
                      f(bi1), f(af2), f(bi2), (float*)out, (float*)ncache, B,
                      C, T, dil, (cudaStream_t)stream);
  if (tm == 16)
    return launch<16>(f(x), f(cache), f(w1t), f(b1), f(w2t), f(b2), f(af1),
                      f(bi1), f(af2), f(bi2), (float*)out, (float*)ncache, B,
                      C, T, dil, (cudaStream_t)stream);
  return -1;
}
