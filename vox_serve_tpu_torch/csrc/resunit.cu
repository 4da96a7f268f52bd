// K2: one residual unit of the Qwen3 codec decoder, for Hopper (sm_90a).
//
// Replaces vox_serve_tpu/ops/pallas_resunit.py:150 `fused_resunit_stack`
// (kernel `_kernel`, pallas_call :195), which runs three chained units
//     out = x + conv1x1(snake2(conv_k7,dil(snake1(x)) + b1)) + b2
// with dilations 1, 3, 9 and streaming halos in and out, one batch row per
// grid step with the whole (T, C) activation in VMEM. snake(x) =
// x + binv * sin(af * x)^2 with af = exp(alpha), binv = 1/(exp(beta)+1e-9).
// The per-unit cache holds the last 6*dil SNAKED input samples.
//
// Arithmetic: multiply-adds, 8*C per output sample-channel (7*C of the
// dilated conv, C of the 1x1 conv), in float32: the codec runs in f32 with
// TF32 off, and the result must stay within 1e-4 of the plain f32 chain,
// which one TF32 pass (~3e-4 at C=768) does not. CUDA cores do ~67 TFLOP/s
// of f32 FMA, the tensor cores 495 TFLOP/s of TF32, so the products run on
// tensor cores in 3xTF32: each f32 operand is split into hi = tf32(a) and
// lo = tf32(a - hi), and wgmma (m64nNk8, TF32) sums lo*hi + hi*lo + hi*hi
// in f32 (lo*lo is below 2^-22 relative). The tensor core truncates as it
// accumulates, an error that grows with K and is biased (~4e-5 of max |out|
// at C=768 when the whole K sums in one accumulator), so each K stage sums
// into a fresh accumulator that is added to the total in IEEE f32 (~1e-6).
//
// Design: three launches per unit, each filling the card with a 2D grid
// of (time tiles) x (output-channel tiles) x B, at every width and at B=1:
//   * snake: y = snake1(x) with the unit's halo in front (the cache, which
//     is already snaked, or zeros), transposed to channel-minor rows and
//     split once into tf32 hi and lo planes, (2, B, 6*dil + T, C); the new
//     cache (the last 6*dil snaked samples) is written here. sinf once per
//     sample, not once per CTA.
//   * conv1: implicit GEMM, M = time steps of one batch row, N = output
//     channels, K = 7 taps x C input channels. A K stage stages 8 input
//     channels of y over the rows [t0 - 6*dil, t0 + BM) and the 7 taps'
//     weights; tap j reads the same staged tile from row j*dil on, which
//     for wgmma is only another start address in its descriptor.
//     Epilogue: + b1, snake2, split, written as z (2, B, T, C) hi/lo
//     planes (8 to 59 MB at B=4, mostly served from the 50 MB L2).
//   * conv2: the same GEMM with one tap over z, 16 channels per stage, and
//     the epilogue out = x + (acc + b2).
// wgmma takes TF32 operands only K-major, so both are staged with the 4
// channels of a 16-byte row contiguous: the activation by the snake pass's
// transpose and conv1's epilogue, the weights by their packing, once per
// parameter set (ops/resunit.py `pack_unit`): (2, taps, C/4, C, 4). The
// tiles carry no swizzle, so a tap's shift by any number of rows keeps the
// layout. Operands reach shared memory by cp.async (16 B), double-buffered:
// the next stage streams in while wgmma works on the current one.
// A CTA is BM/64 warpgroups, each 64 time steps x BN channels, BM in {64,
// 128}, BN in {32, 64}. The wrapper's planner (ops/resunit.py `plan_tiles`)
// picks the tile from a cost model of this kernel.
//
// What bounds it now (H100, 36 TFLOP/s of f32 work at B=4, ~110 TFLOP/s of
// TF32 products, a fifth of the tensor cores' peak): a conv1 stage is 21
// small wgmmas that drain (wait_group 0) before their partial sum is added
// and the next stage is synchronised, so the tensor cores idle unless two
// or three CTAs share the SM; a 32-wide tile reads 3 KB of shared memory
// per 16 clocks of math (a 64-wide one 4 KB per 32); and at C=96 the y and
// z round trips through L2 and HBM. The snake pass is under 10% of a unit.
// sinf, not __sinf: snake arguments are not small. No fast-math.
//
// The bf16 stack (`vox_resunit_bf16`, the codec served at codec_dtype
// bfloat16) keeps the same three launches and implicit-GEMM shape with
// bf16 operands: the rounding points of the Pallas kernel in its serving
// dtype (pallas_resunit.py:80-101): snake1 in f32, rounded to one bf16
// plane y (which is also the new cache); both convs accumulate bf16
// products in f32 (wgmma m64nNk16.f32.bf16.bf16, one product where 3xTF32
// takes three, at the 989 TFLOP/s bf16 peak); conv1's epilogue adds b1
// and applies snake2 in f32, rounded to a bf16 plane z; conv2's adds b2
// and the residual in f32 and rounds the output to bf16. A 16-byte row
// holds 8 channels, so a conv1 stage stages 16 channels (one k16 step per
// tap) and a tap's shift by j*dil rows is still whole 16-byte rows. One
// accumulator sums the whole K: the tensor core's truncation (~1e-5) is
// far below bf16's rounding (2^-9), so no per-stage partial sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPad = 54;  // 6 * the largest dilation

struct Args {
  const float* act;  // conv1: y, conv2: z; (2, B, act_len, C) hi, lo planes
  int act_len;       // time rows of act per batch row
  const float* w;    // (2, taps, C/4, C, 4): tf32 hi, lo planes, K-major
  const float* bias;  // (C,)
  const float* af2;   // snake2 constants (C,); conv1
  const float* bi2;
  const float* res;  // residual x (B, C, T); conv2
  float* dst;        // conv1: z (2, B, T, C); conv2: out (B, C, T)
  int B, C, T, dil;
};

__device__ __forceinline__ float snake(float x, float af, float binv) {
  const float s = sinf(x * af);
  return x + binv * (s * s);
}

// round to the nearest TF32 (10 mantissa bits), ties away from zero
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float2 split(float v) {
  const float h = tf32(v);
  return make_float2(h, tf32(v - h));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills when
// !pred (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

// shared-memory matrix descriptor of a K-major tile without swizzle: rows
// of 16 bytes (4 tf32 or 8 bf16 along K), 8-row core matrices 128 bytes
// apart, the next 16 bytes of K at `kstride` bytes
__device__ __forceinline__ uint64_t desc(const void* p, int kstride) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((kstride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// D (64 x N, f32, in registers) = A (64 x 8) * B (N x 8)^T (+ D if acc),
// both operands TF32 in shared memory; one warpgroup
template <int N>
__device__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db, int acc);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// y = (halo, snake1(x)) transposed to channel-minor rows and split into
// tf32 hi and lo planes: (2, B, pad + T, C); the new cache is the last pad
// snaked samples. A 32 x 32 (channel, sample) tile per block of 32 x 8.
__global__ void __launch_bounds__(256)
    resunit_snake(const float* __restrict__ x, const float* __restrict__ cache,
                  float* __restrict__ ncache, const float* __restrict__ af,
                  const float* __restrict__ bi, float* __restrict__ y, int B,
                  int C, int T, int pad) {
  __shared__ float hi[32][33], lo[32][33];
  const int ylen = pad + T;
  const int u0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, u = u0 + tx;
    float v = 0.f;
    if (c < C && u < ylen) {
      const int64_t row = (int64_t)b * C + c;
      if (u < pad) {
        if (cache) v = cache[row * pad + u];
      } else {
        const int s = u - pad;
        v = snake(x[row * T + s], af[c], bi[c]);
        if (ncache && s >= T - pad) ncache[row * pad + s - (T - pad)] = v;
      }
    }
    const float2 h = split(v);
    hi[ty + 8 * i][tx] = h.x;
    lo[ty + 8 * i][tx] = h.y;
  }
  __syncthreads();
  const int64_t plane = (int64_t)B * ylen * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + ty + 8 * i, c = c0 + tx;
    if (c < C && u < ylen) {
      const int64_t o = ((int64_t)b * ylen + u) * C + c;
      y[o] = hi[tx][ty + 8 * i];
      y[plane + o] = lo[tx][ty + 8 * i];
    }
  }
}

template <int BM, int BN, bool kConv1>
struct Gemm {
  static constexpr int stages = 2;                // the ring of staged K
  static constexpr int threads = 2 * BM;          // a warpgroup per 64 rows
  static constexpr int KC = kConv1 ? 8 : 16;      // input channels per stage
  static constexpr int taps = kConv1 ? 7 : 1;
  static constexpr int steps = kConv1 ? 7 : KC / 8;  // k8 steps per stage
  static constexpr int wstage = 2 * taps * KC * BN;  // floats of weights
  // staged rows of the activation
  __host__ __device__ static constexpr int rows(int dil) {
    return BM + (kConv1 ? 6 * dil : 0);
  }
  static constexpr size_t smem(int dil) {
    return stages * sizeof(float) * (wstage + 2 * KC * rows(dil));
  }
};

template <int BM, int BN, bool kConv1>
__global__ void __launch_bounds__(2 * BM) resunit_gemm(const Args a) {
  using G = Gemm<BM, BN, kConv1>;
  constexpr int KC4 = G::KC / 4;  // 16-byte chunks of K per stage
  extern __shared__ __align__(128) float smem[];
  const int C = a.C, T = a.T;
  const int R = G::rows(a.dil);
  constexpr int S = G::stages;
  float* ws = smem;                   // [S][half][tap][KC4][BN][4]
  float* as = smem + S * G::wstage;   // [S][half][KC4][R][4]
  const int aslot = 2 * G::KC * R;

  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int64_t plane = (int64_t)a.B * a.act_len * C;
  const float* act = a.act + (int64_t)b * a.act_len * C;

  // stage k: runs (half, tap, chunk) of BN weight rows, and runs (half,
  // chunk) of R activation rows from row t0 (y's rows count the halo)
  auto load_stage = [&](int slot, int k) {
    float* wd = ws + slot * G::wstage;
    for (int v = tid; v < 2 * G::taps * KC4 * BN; v += G::threads) {
      const int run = v / BN, n = v - run * BN;
      const int hj = run / KC4, c4 = k * KC4 + run % KC4;
      const bool ok = n0 + n < C && 4 * c4 < C;
      const float* s =
          a.w + (((int64_t)hj * (C / 4) + c4) * C + n0 + n) * 4;
      cp_async16(wd + 4 * v, ok ? s : a.w, ok);
    }
    float* ad = as + slot * aslot;
    for (int v = tid; v < 2 * KC4 * R; v += G::threads) {
      const int run = v / R, r = v - run * R;
      const int half = run / KC4, ci = G::KC * k + 4 * (run % KC4);
      const bool ok = t0 + r < a.act_len && ci < C;
      const float* s = act + half * plane + (int64_t)(t0 + r) * C + ci;
      cp_async16(ad + 4 * v, ok ? s : a.act, ok);
    }
  };

  // A ring of S stages: stages k+1 .. k+S-1 stream in while stage k is
  // multiplied. Each stage sums into a fresh accumulator, which is added
  // to acc once its products are complete (wait_group 0): no other
  // instruction touches the accumulators while a wgmma is in flight, so
  // ptxas keeps the wgmmas of a stage pipelined.
  constexpr int NA = BN / 2;  // accumulator floats per thread
  float acc[NA], part[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = part[i] = 0.f;

  const int nk = (C + G::KC - 1) / G::KC;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < nk) load_stage(k, k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < nk; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    // cp.async writes are generic-proxy; wgmma reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage k landed; every warpgroup is done with k-1
    if (k + S - 1 < nk) load_stage((k + S - 1) % S, k + S - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* wst = ws + (k % S) * G::wstage;
    const float* ahi = as + (k % S) * aslot + 64 * 4 * wg;
    const float* alo = ahi + G::KC * R;
    fence_operands(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < G::steps; ++s) {
      // conv1: step s is tap s, its rows shifted by s*dil; conv2: step s is
      // chunks 2s, 2s+1. Either way the weights are chunks 2s, 2s+1.
      const float* ah = ahi + (kConv1 ? s * a.dil : 2 * s * R) * 4;
      const float* al = alo + (kConv1 ? s * a.dil : 2 * s * R) * 4;
      const float* wh = wst + 2 * s * BN * 4;
      const float* wl = wh + G::wstage / 2;
      const uint64_t dah = desc(ah, R * 16), dal = desc(al, R * 16);
      const uint64_t dbh = desc(wh, BN * 16), dbl = desc(wl, BN * 16);
      // s == 0 drops what the accumulator held
      wgmma<BN>(part, dal, dbh, s > 0);
      wgmma<BN>(part, dah, dbl, 1);
      wgmma<BN>(part, dah, dbh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] += part[i];
  }

  // epilogue: accumulator 4i + 2e0 + e1 is time step 64wg + 16w + g + 8e0,
  // channel 8i + 2q + e1 (w the warp of the warpgroup)
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
  const int64_t zplane = (int64_t)a.B * T * C;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int co = n0 + 8 * i + 2 * q;
    if (co >= C) continue;
    const float b0 = a.bias[co], b1 = a.bias[co + 1];
#pragma unroll
    for (int e0 = 0; e0 < 2; ++e0) {
      const int t = t0 + 64 * wg + 16 * w + g + 8 * e0;
      if (t >= T) continue;
      const float v0 = acc[4 * i + 2 * e0] + b0;
      const float v1 = acc[4 * i + 2 * e0 + 1] + b1;
      if (kConv1) {
        const float2 s0 = split(snake(v0, a.af2[co], a.bi2[co]));
        const float2 s1 = split(snake(v1, a.af2[co + 1], a.bi2[co + 1]));
        float2* z = reinterpret_cast<float2*>(
            a.dst + ((int64_t)b * T + t) * C + co);
        z[0] = make_float2(s0.x, s1.x);
        z[zplane / 2] = make_float2(s0.y, s1.y);
      } else {
        const int64_t o = ((int64_t)b * C + co) * T + t;
        a.dst[o] = a.res[o] + v0;
        a.dst[o + T] = a.res[o + T] + v1;
      }
    }
  }
}

template <int BM, int BN, bool kConv1>
int launch(const Args& a, cudaStream_t stream) {
  using G = Gemm<BM, BN, kConv1>;
  const size_t smem = G::smem(a.dil);
  cudaError_t err = cudaFuncSetAttribute(
      resunit_gemm<BM, BN, kConv1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + BM - 1) / BM, (a.C + BN - 1) / BN, a.B);
  resunit_gemm<BM, BN, kConv1><<<grid, G::threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BN, bool kConv1>
int launch_m(const Args& a, int bm, cudaStream_t st) {
  if (bm == 128) return launch<128, BN, kConv1>(a, st);
  if (bm == 64) return launch<64, BN, kConv1>(a, st);
  return -1;
}

template <bool kConv1>
int launch_tiles(const Args& a, int bm, int bn, cudaStream_t st) {
  if (bn == 64) return launch_m<64, kConv1>(a, bm, st);
  if (bn == 32) return launch_m<32, kConv1>(a, bm, st);
  return -1;
}

// ---------------------------------------------------------------------------
// bf16: the same unit with bf16 operands and f32 accumulation and snake
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

struct ArgsH {
  const bf16* act;   // conv1: y, conv2: z; (B, act_len, C), one plane
  int act_len;       // time rows of act per batch row
  const bf16* w;     // (taps, C/8, C, 8), K-major
  const float* bias;  // (C,)
  const float* af2;   // snake2 constants (C,); conv1
  const float* bi2;
  const bf16* res;   // residual x (B, C, T); conv2
  bf16* dst;         // conv1: z (B, T, C); conv2: out (B, C, T)
  int B, C, T, dil;
};

// D (64 x N, f32, in registers) = A (64 x 16) * B (N x 16)^T (+ D if acc),
// both operands bf16, K-major, in shared memory; one warpgroup
template <int N>
__device__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db,
                           int acc);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}
template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// y = (halo, bf16(snake1(x))) transposed to channel-minor rows, (B, pad +
// T, C); the new cache is the last pad rounded samples. A 32 x 32
// (channel, sample) tile per block of 32 x 8.
__global__ void __launch_bounds__(256)
    resunit_snake_bf16(const bf16* __restrict__ x,
                       const bf16* __restrict__ cache,
                       bf16* __restrict__ ncache, const float* __restrict__ af,
                       const float* __restrict__ bi, bf16* __restrict__ y,
                       int B, int C, int T, int pad) {
  __shared__ unsigned short tile[32][34];  // bf16 bits
  const int ylen = pad + T;
  const int u0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 8 * i, u = u0 + tx;
    bf16 v = __float2bfloat16_rn(0.f);
    if (c < C && u < ylen) {
      const int64_t row = (int64_t)b * C + c;
      if (u < pad) {
        if (cache) v = cache[row * pad + u];
      } else {
        const int s = u - pad;
        v = __float2bfloat16_rn(
            snake(__bfloat162float(x[row * T + s]), af[c], bi[c]));
        if (ncache && s >= T - pad) ncache[row * pad + s - (T - pad)] = v;
      }
    }
    tile[ty + 8 * i][tx] = __bfloat16_as_ushort(v);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = u0 + ty + 8 * i, c = c0 + tx;
    if (c < C && u < ylen)
      y[((int64_t)b * ylen + u) * C + c] =
          __ushort_as_bfloat16(tile[tx][ty + 8 * i]);
  }
}

template <int BM, int BN, bool kConv1>
struct GemmH {
  static constexpr int stages = 2;
  static constexpr int threads = 2 * BM;          // a warpgroup per 64 rows
  static constexpr int KC = kConv1 ? 16 : 32;     // input channels per stage
  static constexpr int KC8 = KC / 8;              // 16-byte chunks of K
  static constexpr int taps = kConv1 ? 7 : 1;
  static constexpr int steps = kConv1 ? 7 : KC / 16;  // k16 steps per stage
  static constexpr int wstage = taps * KC * BN;   // bf16 of weights
  __host__ __device__ static constexpr int rows(int dil) {
    return BM + (kConv1 ? 6 * dil : 0);
  }
  static constexpr size_t smem(int dil) {
    return stages * sizeof(bf16) * (wstage + KC * rows(dil));
  }
};

template <int BM, int BN, bool kConv1>
__global__ void __launch_bounds__(2 * BM) resunit_gemm_bf16(const ArgsH a) {
  using G = GemmH<BM, BN, kConv1>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int C = a.C, T = a.T;
  const int R = G::rows(a.dil);
  constexpr int S = G::stages;
  bf16* ws = smem;                   // [S][tap][KC8][BN][8]
  bf16* as = smem + S * G::wstage;   // [S][KC8][R][8]
  const int aslot = G::KC * R;

  const int t0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const bf16* act = a.act + (int64_t)b * a.act_len * C;

  // stage k: runs (tap, chunk) of BN weight rows, and runs (chunk) of R
  // activation rows from row t0 (y's rows count the halo)
  auto load_stage = [&](int slot, int k) {
    bf16* wd = ws + slot * G::wstage;
    for (int v = tid; v < G::taps * G::KC8 * BN; v += G::threads) {
      const int run = v / BN, n = v - run * BN;
      const int tap = run / G::KC8, c8 = k * G::KC8 + run % G::KC8;
      const bool ok = n0 + n < C && 8 * c8 < C;
      const bf16* s = a.w + (((int64_t)tap * (C / 8) + c8) * C + n0 + n) * 8;
      cp_async16(wd + 8 * v, ok ? s : a.w, ok);
    }
    bf16* ad = as + slot * aslot;
    for (int v = tid; v < G::KC8 * R; v += G::threads) {
      const int run = v / R, r = v - run * R;
      const int ci = G::KC * k + 8 * run;
      const bool ok = t0 + r < a.act_len && ci < C;
      const bf16* s = act + (int64_t)(t0 + r) * C + ci;
      cp_async16(ad + 8 * v, ok ? s : a.act, ok);
    }
  };

  constexpr int NA = BN / 2;  // accumulator floats per thread
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  const int nk = (C + G::KC - 1) / G::KC;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < nk) load_stage(k, k);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int k = 0; k < nk; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage k landed; every warpgroup is done with k-1
    if (k + S - 1 < nk) load_stage((k + S - 1) % S, k + S - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const bf16* wst = ws + (k % S) * G::wstage;
    const bf16* a0 = as + (k % S) * aslot + 64 * 8 * wg;
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < G::steps; ++s) {
      // conv1: step s is tap s, its rows shifted by s*dil; conv2: step s is
      // chunks 2s, 2s+1. Either way the weights are chunks 2s, 2s+1.
      const bf16* ap = a0 + (kConv1 ? s * a.dil : 2 * s * R) * 8;
      const bf16* wp = wst + 2 * s * BN * 8;
      wgmma_bf16<BN>(acc, desc(ap, R * 16), desc(wp, BN * 16),
                     k > 0 || s > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
  }

  // epilogue: accumulator 4i + 2e0 + e1 is time step 64wg + 16w + g + 8e0,
  // channel 8i + 2q + e1 (w the warp of the warpgroup)
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int co = n0 + 8 * i + 2 * q;
    if (co >= C) continue;
    const float b0 = a.bias[co], b1 = a.bias[co + 1];
#pragma unroll
    for (int e0 = 0; e0 < 2; ++e0) {
      const int t = t0 + 64 * wg + 16 * w + g + 8 * e0;
      if (t >= T) continue;
      const float v0 = acc[4 * i + 2 * e0] + b0;
      const float v1 = acc[4 * i + 2 * e0 + 1] + b1;
      if (kConv1) {
        *reinterpret_cast<__nv_bfloat162*>(a.dst + ((int64_t)b * T + t) * C +
                                           co) =
            __floats2bfloat162_rn(snake(v0, a.af2[co], a.bi2[co]),
                                  snake(v1, a.af2[co + 1], a.bi2[co + 1]));
      } else {
        const int64_t o = ((int64_t)b * C + co) * T + t;
        a.dst[o] = __float2bfloat16_rn(__bfloat162float(a.res[o]) + v0);
        a.dst[o + T] =
            __float2bfloat16_rn(__bfloat162float(a.res[o + T]) + v1);
      }
    }
  }
}

template <int BM, int BN, bool kConv1>
int launch_bf16(const ArgsH& a, cudaStream_t stream) {
  using G = GemmH<BM, BN, kConv1>;
  const size_t smem = G::smem(a.dil);
  cudaError_t err = cudaFuncSetAttribute(
      resunit_gemm_bf16<BM, BN, kConv1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.T + BM - 1) / BM, (a.C + BN - 1) / BN, a.B);
  resunit_gemm_bf16<BM, BN, kConv1><<<grid, G::threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kConv1>
int launch_tiles_bf16(const ArgsH& a, int bm, int bn, cudaStream_t st) {
  if (bn == 64 && bm == 128) return launch_bf16<128, 64, kConv1>(a, st);
  if (bn == 64 && bm == 64) return launch_bf16<64, 64, kConv1>(a, st);
  if (bn == 32 && bm == 128) return launch_bf16<128, 32, kConv1>(a, st);
  if (bn == 32 && bm == 64) return launch_bf16<64, 32, kConv1>(a, st);
  return -1;
}

}  // namespace

// Plain C entry, loaded with ctypes: one residual unit, three launches
// (snake into y, conv1 into z, conv2 into out). x, out: (B, C, T); cache,
// ncache: (B, C, 6*dil) or null (zero halo, no new cache); y: scratch of
// 2*B*(6*dil + T)*C floats; z: scratch of 2*B*T*C floats; w1: (2, 7, C/4,
// C, 4) and w2: (2, 1, C/4, C, 4), the tf32 hi and lo planes of the
// weights, K-major; b1, b2, af1, bi1, af2, bi2: (C,). All float32 device
// pointers, contiguous and 16-byte aligned; C % 8 == 0; 1 <= dil <= 9; bm
// in {64, 128}, bn in {32, 64}. Returns cudaGetLastError() after the
// launches (0 = success), -1 for a bad tile, dilation or C.
extern "C" int vox_resunit(const void* x, const void* cache, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const void* af1, const void* bi1, const void* af2,
                           const void* bi2, void* y, void* z, void* out,
                           void* ncache, int B, int C, int T, int dil, int bm,
                           int bn, void* stream) {
  if (dil < 1 || 6 * dil > kMaxPad || C % 8) return -1;
  if ((bm != 64 && bm != 128) || (bn != 32 && bn != 64)) return -1;
  if (B == 0 || T == 0) return 0;
  auto f = [](const void* p) { return (const float*)p; };
  cudaStream_t st = (cudaStream_t)stream;
  const int pad = 6 * dil;
  dim3 sgrid((pad + T + 31) / 32, (C + 31) / 32, B);
  resunit_snake<<<sgrid, dim3(32, 8), 0, st>>>(
      f(x), f(cache), (float*)ncache, f(af1), f(bi1), (float*)y, B, C, T,
      pad);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  Args a1{f(y), pad + T, f(w1), f(b1), f(af2), f(bi2), nullptr, (float*)z,
          B, C, T, dil};
  err = launch_tiles<true>(a1, bm, bn, st);
  if (err != 0) return err;
  Args a2{f(z), T, f(w2), f(b2), nullptr, nullptr, f(x), (float*)out, B, C,
          T, dil};
  return launch_tiles<false>(a2, bm, bn, st);
}

// The same unit in bf16: x, out, cache, ncache, y (B*(6*dil + T)*C
// elements), z (B*T*C) and the weights, w1: (7, C/8, C, 8) and w2: (1,
// C/8, C, 8), K-major, are bf16; b1, b2, af1, bi1, af2, bi2 stay float32.
// Same contract and return codes as vox_resunit.
extern "C" int vox_resunit_bf16(const void* x, const void* cache,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* af1, const void* bi1,
                                const void* af2, const void* bi2, void* y,
                                void* z, void* out, void* ncache, int B,
                                int C, int T, int dil, int bm, int bn,
                                void* stream) {
  if (dil < 1 || 6 * dil > kMaxPad || C % 8) return -1;
  if ((bm != 64 && bm != 128) || (bn != 32 && bn != 64)) return -1;
  if (B == 0 || T == 0) return 0;
  auto f = [](const void* p) { return (const float*)p; };
  auto h = [](const void* p) { return (const bf16*)p; };
  cudaStream_t st = (cudaStream_t)stream;
  const int pad = 6 * dil;
  dim3 sgrid((pad + T + 31) / 32, (C + 31) / 32, B);
  resunit_snake_bf16<<<sgrid, dim3(32, 8), 0, st>>>(
      h(x), h(cache), (bf16*)ncache, f(af1), f(bi1), (bf16*)y, B, C, T, pad);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ArgsH a1{h(y), pad + T, h(w1), f(b1), f(af2), f(bi2), nullptr, (bf16*)z,
           B, C, T, dil};
  err = launch_tiles_bf16<true>(a1, bm, bn, st);
  if (err != 0) return err;
  ArgsH a2{h(z), T, h(w2), f(b2), nullptr, nullptr, h(x), (bf16*)out, B, C,
           T, dil};
  return launch_tiles_bf16<false>(a2, bm, bn, st);
}
