// K5: w8a16_linear, the int8 weight-only linear of the backbone, for Hopper
// (sm_90a).
//
//   y[m, n] = bf16(bf16(sum_k x[m, k] * q[k, n]) * bf16(s[n]))  (+ b[n],
//             rounded to bf16)
//
// x: (M, K) bf16, row-major. q: (K, N) int8, row-major with N contiguous:
// one layer's view of the stacked (L, K, N) `w_q` leaf in the JAX package's
// (d_in, d_out) layout. s: (N,) float32 per-output-channel scales. b: (N,)
// bf16 or null. The sum accumulates in float32; the rounding points are
// those of vox_serve_tpu/models/backbone.py `linear`'s `w_q` branch
// (`(x @ w_q.astype(x.dtype)) * w_s.astype(x.dtype)`, then `+ b`), which
// the plain version in ops/kernels.py repeats.
//
// Replaces no Pallas kernel: on the TPU this is the XLA fusion that converts
// int8 to bf16 inside the matmul. It is not `x @ w_q.to(bf16)`: that would
// write and re-read a bf16 copy of every weight on every step, three times
// the int8 bytes, which defeats the mode.
//
// What bounds it on an H100: bytes at decode (M <= 16 rows: each weight
// byte serves M multiply-adds, far below the ~295 flop/byte ridge, so the
// whole cost is streaming K*N int8 bytes at HBM rate), operations at
// prefill (M = 128 / 1024 tokens).
//
// Two plans, picked on the host from the shapes alone (ops/kernels.py
// plan_w8a16):
//   * small M (M <= 16), `w8a16_gemv`: a CTA of 4 warps owns a strip of 128
//     columns (fewer where the vector width is below 4) and a contiguous
//     range of K. The CTA first stages the x rows of its range in shared
//     memory as float32 (one barrier; read back as broadcasts), then each
//     warp streams its rows with no barrier: each lane loads VEC int8
//     weights of one row per load (16, 8 or 4 bytes along N: neighbouring
//     lanes read neighbouring addresses, a warp's load covers whole
//     128-byte lines), 8-32 rows in flight per lane, and converts them to
//     float32 with one byte permute and one add each (the 2^23 magic
//     number). Registers are capped so that 4 CTAs (2 at M > 4) share an
//     SM and keep its loads in flight. The M x VEC float32 accumulators of
//     a lane are reduced over the lanes and warps that took other rows of
//     the strip, in a fixed order.
//     Split-K (the grid's y) gives Orpheus's and GLM's widths enough CTAs
//     to fill 132 SMs: each split writes its partial sums to a scratch
//     buffer (the worker sizes one at start-up) and the CTA that arrives
//     last on the strip's atomic counter adds them in split order, applies
//     the epilogue, and resets the counter for the next launch. No float
//     atomics: a replay gives the same bits.
//   * large M, `w8a16_tiled`: 64 x 64 output tiles, 4 warps of 32 x 32,
//     bf16 mma.sync m16n8k16 with float32 accumulators. x and int8 tiles
//     of 32 along K are staged by cp.async in a 3-stage ring (an operand
//     that is not 16-byte aligned, or a width that is not a multiple of 8 /
//     16, takes the same kernel with plain element loads instead); the CTA
//     converts each int8 tile to bf16 in shared memory once (exact: |q| <=
//     127), and the warps read both operands with ldmatrix (the weights
//     transposed). The bf16 weights exist only as that one tile.
// Both launch on the caller's stream, allocate nothing and never
// synchronise, so they capture into CUDA graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGemvWarps = 4;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kChunk = 128;  // rows of K a CTA's lanes load per round
// float32 x values a CTA stages at most: MT rows x its K range
// (ops/kernels.py plan_w8a16 keeps rows_per_split * MT within it), 32 KB
// of dynamic shared memory
constexpr int kGemvSmemFloats = 8192;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the JAX rounding points: bf16(sum), times bf16(scale), rounded; then the
// bias, rounded
__device__ __forceinline__ __nv_bfloat16 epilogue(float acc, const float* s,
                                                  const __nv_bfloat16* b,
                                                  int n) {
  __nv_bfloat16 y = __float2bfloat16(bf16_round(acc) * bf16_round(s[n]));
  if (b != nullptr)
    y = __float2bfloat16(__bfloat162float(y) + __bfloat162float(b[n]));
  return y;
}

// byte `i` of a word whose bytes were biased by 128 (w ^ 0x80808080) ->
// the original int8 value as float32: 0x4B0000XX is 2^23 + XX
template <int I>
__device__ __forceinline__ float biased_byte(unsigned u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | I)) -
         8388736.f;
}

template <int VEC>
struct Weights {
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;
  unsigned w[kWords];

  __device__ __forceinline__ void load(const int8_t* p, bool ok) {
    if constexpr (VEC == 16) {
      const uint4 v = ok ? __ldcs(reinterpret_cast<const uint4*>(p))
                         : make_uint4(0u, 0u, 0u, 0u);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (VEC == 8) {
      const uint2 v = ok ? __ldcs(reinterpret_cast<const uint2*>(p))
                         : make_uint2(0u, 0u);
      w[0] = v.x; w[1] = v.y;
    } else if constexpr (VEC == 4) {
      w[0] = ok ? __ldcs(reinterpret_cast<const unsigned*>(p)) : 0u;
    } else {
      w[0] = ok ? (unsigned)__ldcs(reinterpret_cast<const unsigned char*>(p))
                : 0u;
    }
  }

  __device__ __forceinline__ void to_float(float* f) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const unsigned u = w[i] ^ 0x80808080u;
      f[4 * i] = biased_byte<0>(u);
      if constexpr (VEC >= 4) {
        f[4 * i + 1] = biased_byte<1>(u);
        f[4 * i + 2] = biased_byte<2>(u);
        f[4 * i + 3] = biased_byte<3>(u);
      }
    }
  }
};

// Small-M plan. MT: rows of x the instance holds (M <= MT, the rest zero);
// VEC: int8 columns a lane loads per row.
template <int MT, int VEC>
__global__ void __launch_bounds__(kGemvThreads, MT <= 4 ? 4 : 2)
    w8a16_gemv(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               const __nv_bfloat16* __restrict__ b,
               __nv_bfloat16* __restrict__ y, float* __restrict__ part,
               int* __restrict__ counters, int M, int K, int N,
               int rows_per_split) {
  constexpr int kLanesN = VEC >= 4 ? 128 / VEC : 32;  // lanes along N
  constexpr int kLanesK = 32 / kLanesN;               // rows per warp load
  constexpr int kStrip = kLanesN * VEC;               // columns per CTA
  constexpr int kRowLanes = kGemvWarps * kLanesK;     // rows per CTA load
  constexpr int kRows = kChunk / kRowLanes;           // loads per lane
  static_assert(kGemvWarps * MT * kStrip <= kGemvSmemFloats, "smem");
  // x as [m][row of the range] while streaming, then the per-warp sums
  // [warp][m][c] (launch_gemv sizes it for the larger)
  extern __shared__ __align__(16) float smem[];
  __shared__ bool s_last;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ln = lane % kLanesN;
  const int rl = warp * kLanesK + lane / kLanesN;
  const int strip = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int n0 = strip * kStrip + ln * VEC;
  const bool col_ok = n0 < N;  // N % VEC == 0: the lane's VEC are all in
  const int kb = split * rows_per_split;
  const int ke = min(K, kb + rows_per_split);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;

  const int rows = ke - kb;
  for (int i = threadIdx.x; i < MT * rows_per_split; i += kGemvThreads) {
    const int m = i / rows_per_split, r = i - m * rows_per_split;
    smem[i] = (m < M && r < rows)
                  ? __bfloat162float(x[(int64_t)m * K + kb + r])
                  : 0.f;
  }
  __syncthreads();
  for (int r0 = 0; r0 < rows; r0 += kChunk) {
    Weights<VEC> w[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = r0 + rl + j * kRowLanes;
      w[j].load(q + (int64_t)(kb + r) * N + n0, col_ok && r < rows);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      float wf[VEC];
      w[j].to_float(wf);
      const float* xr = smem + r0 + rl + j * kRowLanes;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xr[m * rows_per_split];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[m][v] = fmaf(xv, wf[v], acc[m][v]);
      }
    }
  }

  // reduce over the lanes of a warp that took other rows (same columns)
#pragma unroll
  for (int off = kLanesN; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], off);
  __syncthreads();  // smem turns from x into the per-warp sums
  if (lane < kLanesN) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        smem[(warp * MT + m) * kStrip + ln * VEC + v] = acc[m][v];
  }
  __syncthreads();
  // then over the warps, in order; one (row, column) per thread
  for (int i = threadIdx.x; i < M * kStrip; i += kGemvThreads) {
    const int m = i / kStrip, c = i - m * kStrip;
    const int n = strip * kStrip + c;
    if (n >= N) continue;
    float t = smem[m * kStrip + c];
#pragma unroll
    for (int wp = 1; wp < kGemvWarps; ++wp)
      t += smem[(wp * MT + m) * kStrip + c];
    if (splits == 1)
      y[(int64_t)m * N + n] = epilogue(t, s, b, n);
    else
      part[((int64_t)split * M + m) * N + n] = t;
  }
  if (splits == 1) return;

  // the last split of this strip adds the partial sums in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&counters[strip], 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * kStrip; i += kGemvThreads) {
    const int m = i / kStrip, c = i - m * kStrip;
    const int n = strip * kStrip + c;
    if (n >= N) continue;
    float t = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      t += __ldcg(part + ((int64_t)sp * M + m) * N + n);
    y[(int64_t)m * N + n] = epilogue(t, s, b, n);
  }
  if (threadIdx.x == 0) counters[strip] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// large M: tiled bf16 mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kStages = 3;
constexpr int kTiledThreads = 128;
constexpr int kAStride = kBK + 8;    // bf16 per staged x row (80 bytes)
constexpr int kQStride = kBN + 16;   // bytes per staged int8 row (80)
constexpr int kBStride = kBN + 8;    // bf16 per converted row (144 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(const void* p, unsigned r[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, unsigned r[4]) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 4 int8 (one word) -> 2 words of bf16 pairs, low byte first (exact)
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned* o) {
  const unsigned u = w ^ 0x80808080u;
  o[0] = pack_bf16(biased_byte<0>(u), biased_byte<1>(u));
  o[1] = pack_bf16(biased_byte<2>(u), biased_byte<3>(u));
}

// kAligned: K % 8 == 0, N % 16 == 0 and x, q 16-byte aligned (cp.async of
// 16-byte pieces); else plain element loads into the same ring
template <bool kAligned>
__global__ void __launch_bounds__(kTiledThreads)
    w8a16_tiled(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q, const float* __restrict__ s,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ y, int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[kStages][kBM * kAStride];
  __shared__ __align__(16) int8_t Qs[kStages][kBK * kQStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBK * kBStride];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int ktiles = (K + kBK - 1) / kBK;

  auto load = [&](int kt, int st) {
    const int k0 = kt * kBK;
    if constexpr (kAligned) {
#pragma unroll
      for (int i = tid; i < kBM * (kBK / 8); i += kTiledThreads) {
        const int r = i / (kBK / 8), c = i % (kBK / 8);
        const int m = m0 + r, k = k0 + c * 8;
        const bool ok = m < M && k < K;
        cp_async16(&As[st][r * kAStride + c * 8],
                   ok ? (const void*)(x + (int64_t)m * K + k)
                      : (const void*)x,
                   ok);
      }
      {
        const int r = tid / (kBN / 16), c = tid % (kBN / 16);
        const int k = k0 + r, n = n0 + c * 16;
        const bool ok = k < K && n < N;
        cp_async16(&Qs[st][r * kQStride + c * 16],
                   ok ? (const void*)(q + (int64_t)k * N + n)
                      : (const void*)q,
                   ok);
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kTiledThreads) {
        const int r = i / kBK, c = i % kBK;
        const int m = m0 + r, k = k0 + c;
        As[st][r * kAStride + c] = (m < M && k < K)
                                       ? x[(int64_t)m * K + k]
                                       : __float2bfloat16(0.f);
      }
      for (int i = tid; i < kBK * kBN; i += kTiledThreads) {
        const int r = i / kBN, c = i % kBN;
        const int k = k0 + r, n = n0 + c;
        Qs[st][r * kQStride + c] =
            (k < K && n < N) ? q[(int64_t)k * N + n] : (int8_t)0;
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's part)
    __syncthreads();               // ... everyone's; kt-1's Bs is consumed
    const int nk = kt + kStages - 1;
    if (nk < ktiles) load(nk, nk % kStages);
    cp_async_commit();
    {  // the int8 tile -> bf16 once per CTA: 16 bytes per thread
      const int r = tid / (kBN / 16), c = tid % (kBN / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(
          &Qs[kt % kStages][r * kQStride + c * 16]);
      uint4 lo, hi;
      i8x4_to_bf16(v.x, &lo.x);
      i8x4_to_bf16(v.y, &lo.z);
      i8x4_to_bf16(v.z, &hi.x);
      i8x4_to_bf16(v.w, &hi.z);
      uint4* dst = reinterpret_cast<uint4*>(&Bs[r * kBStride + c * 16]);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();
    const __nv_bfloat16* A = As[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(A + (wm + i * 16 + (lane & 15)) * kAStride + kk +
                    (lane >> 4) * 8,
                af[i]);
#pragma unroll
      for (int p = 0; p < 2; ++p)  // b0, b1 of n-tiles 2p and 2p + 1
        ldsm_x4_t(Bs + (kk + (lane & 15)) * kBStride + wn + p * 16 +
                      (lane >> 4) * 8,
                  bf[p]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_bf16(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                   bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (m < M && n < N)
          y[(int64_t)m * N + n] = epilogue(acc[i][j][e], s, b, n);
      }
}

template <int MT, int VEC>
int launch_gemv(const void* x, const void* q, const void* s, const void* b,
                void* y, void* part, void* counters, int M, int K, int N,
                int splits, int rows_per_split, cudaStream_t stream) {
  constexpr int kStrip = (VEC >= 4 ? 128 / VEC : 32) * VEC;
  const int floats = MT * rows_per_split > kGemvWarps * MT * kStrip
                         ? MT * rows_per_split
                         : kGemvWarps * MT * kStrip;
  dim3 grid((N + kStrip - 1) / kStrip, splits);
  w8a16_gemv<MT, VEC><<<grid, kGemvThreads, floats * sizeof(float),
                        stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)y, (float*)part,
      (int*)counters, M, K, N, rows_per_split);
  return (int)cudaGetLastError();
}

// the vector widths each row count takes: a lane's MT x VEC accumulators
// stay at 64 or fewer
template <int MT>
int gemv_vec(int vec, const void* x, const void* q, const void* s,
             const void* b, void* y, void* part, void* counters, int M, int K,
             int N, int splits, int rows_per_split, cudaStream_t stream) {
  switch (vec) {
    case 16:
      if constexpr (MT <= 4)
        return launch_gemv<MT, 16>(x, q, s, b, y, part, counters, M, K, N,
                                   splits, rows_per_split, stream);
      return -1;
    case 8:
      if constexpr (MT <= 8)
        return launch_gemv<MT, 8>(x, q, s, b, y, part, counters, M, K, N,
                                  splits, rows_per_split, stream);
      return -1;
    case 4:
      return launch_gemv<MT, 4>(x, q, s, b, y, part, counters, M, K, N,
                                splits, rows_per_split, stream);
    case 1:
      return launch_gemv<MT, 1>(x, q, s, b, y, part, counters, M, K, N,
                                splits, rows_per_split, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. `vec` > 0: the small-M plan (M <= 16)
// with `vec` int8 columns per load (16, 8 or 4 up to 64 / pow2(M), or 1),
// `splits` CTAs along K of `rows_per_split` rows each (a multiple of 128,
// times pow2(M) at most 8192);
// `part` (splits * M * N floats) and `counters` (one per strip, zero) are
// needed where splits > 1. `vec` == 0: the tiled plan, `aligned` choosing
// cp.async staging. `b` may be null. Returns cudaGetLastError() after the
// launch (0 = success), -1 for arguments no instance takes.
extern "C" int vox_w8a16_linear(const void* x, const void* q, const void* s,
                                const void* b, void* y, void* part,
                                void* counters, int M, int K, int N, int vec,
                                int splits, int rows_per_split, int aligned,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec == 0) {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    if (aligned)
      w8a16_tiled<true><<<grid, kTiledThreads, 0, st>>>(
          (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s,
          (const __nv_bfloat16*)b, (__nv_bfloat16*)y, M, K, N);
    else
      w8a16_tiled<false><<<grid, kTiledThreads, 0, st>>>(
          (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s,
          (const __nv_bfloat16*)b, (__nv_bfloat16*)y, M, K, N);
    return (int)cudaGetLastError();
  }
  int mt = 1;
  while (mt < M) mt *= 2;
  if (splits < 1 || rows_per_split < 1 || rows_per_split % kChunk ||
      mt * rows_per_split > kGemvSmemFloats ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return -1;
  if (M <= 1)
    return gemv_vec<1>(vec, x, q, s, b, y, part, counters, M, K, N, splits,
                       rows_per_split, st);
  if (M <= 2)
    return gemv_vec<2>(vec, x, q, s, b, y, part, counters, M, K, N, splits,
                       rows_per_split, st);
  if (M <= 4)
    return gemv_vec<4>(vec, x, q, s, b, y, part, counters, M, K, N, splits,
                       rows_per_split, st);
  if (M <= 8)
    return gemv_vec<8>(vec, x, q, s, b, y, part, counters, M, K, N, splits,
                       rows_per_split, st);
  if (M <= 16)
    return gemv_vec<16>(vec, x, q, s, b, y, part, counters, M, K, N, splits,
                        rows_per_split, st);
  return -1;
}
