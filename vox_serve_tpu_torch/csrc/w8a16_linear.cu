// K5: w8a16_linear, the int8 weight-only linear of the backbone, for Hopper
// (sm_90a).
//
//   y[m, n] = bf16(bf16(sum_k x[m, k] * q[k, n]) * bf16(s[n]))  (+ b[n],
//             rounded to bf16)
//
// x: (M, K) bf16, row-major. q: one layer's (K, N) int8 weight, the JAX
// package's (d_in, d_out) `w_q`, held here in the packed layout below (the
// worker packs every quantized leaf once, before any capture:
// ops/kernels.py `pack_w8a16`). s: (N,) float32 per-output-channel scales.
// b: (N,) bf16 or null. The sum accumulates in float32; the rounding points
// are those of vox_serve_tpu/models/backbone.py `linear`'s `w_q` branch
// (`(x @ w_q.astype(x.dtype)) * w_s.astype(x.dtype)`, then `+ b`), which
// the plain version in ops/kernels.py repeats.
//
// Replaces no Pallas kernel: on the TPU this is the XLA fusion that converts
// int8 to bf16 inside the matmul. It is not `x @ w_q.to(bf16)`: that would
// write and re-read a bf16 copy of every weight on every step, three times
// the int8 bytes, which defeats the mode.
//
// What bounds it on an H100: bytes up to ~150 rows (each int8 weight byte
// serves M multiply-adds; the bf16 tensor cores need ~295 per byte), then
// operations (the 1024-token prefill bucket).
//
// Design: one swap-AB warpgroup kernel for every row count. It computes
// y^T = W^T x^T: the output features take wgmma's 64-row M, the tokens its
// N (M rounded up to one of 8, 16, 32, 64, 128, 192, 256; more rows take
// several token tiles of at most 256), so a weight tile is read once for up
// to 256 tokens.
//   * Packed layout: a (K, N) weight is cut into units of 64 features x 64
//     K, 4096 contiguous bytes each, ordered [feature unit][K tile]; K and
//     N are zero-padded to whole units (nothing at any served family's
//     widths, all multiples of 64). Inside a unit, consumer
//     thread t of a warpgroup owns bytes [16 t, 16 t + 16) of each half:
//     the A fragments (wgmma's register layout: rows g and g + 8, k 2q,
//     2q + 1, 2q + 8, 2q + 9) of two k16 steps, so one 16-byte shared
//     load gives a thread its weights for two steps.
//   * A CTA is two consumer warpgroups (128 features, 64 each) and one
//     producer warp. The producer keeps a ring of S stages in flight: per
//     stage one `cp.async.bulk` of each warpgroup's 4096-byte unit and one
//     TMA load of the x tile (tokens x 64 K, bf16, K-major with the
//     128-byte swizzle: wgmma's native B layout; rows past M and columns
//     past K read as zeros), completing on the stage's full mbarrier.
//   * Each consumer converts its int8 fragment to bf16 in registers (a
//     byte permute into 2^23 + (q + 128), one float add, and the high
//     halves of two floats as one bf16 pair: exact for |q| <= 127), then
//     issues four wgmma m64nBMk16 with A from registers and B from the
//     x tile, accumulating in float32. One wgmma group stays in flight
//     while the next stage converts; a stage is released (empty mbarrier,
//     one arrival per consumer warp) when its group has completed.
//   * Split-K where the feature x token tiles fall short of the SMs
//     (plan_w8a16 on the host): each split writes its float32 partial sums
//     in register order to the caller's scratch; the CTA that arrives last
//     on the tile's counter adds them in split order, so a replay gives the
//     same bits, and zeroes the counter for the next launch.
//   * Epilogue: the JAX rounding points per element, then y (tokens, N)
//     staged through shared memory and stored in 16-byte rows.
//   * Grouped launches: one launch takes up to three linears that share x
//     (q, k, v; gate, up): their feature tiles are concatenated over three
//     pointer sets passed by value, so a layer makes 4 launches, not 7.
//   * Registers: a consumer thread holds BM / 2 accumulators and two
//     stages of A fragments. From 128 tokens on, the producer is a whole
//     warpgroup that drops to 40 registers with `setmaxnreg` so that the
//     consumers rise to 232 (without it, 256 tokens serialise the wgmmas
//     for want of registers); narrower tiles take a lone producer warp and
//     the registers the launch gives (two CTAs an SM up to 32).
// What holds it below its bound on an H100 (PERF.md, section 6): at
// decode rows, a fixed cost a launch (the launch, the ring's first bytes,
// the split merge, the epilogue) and the conversion's issue slots (11
// instructions per 4 weight bytes, a large share of an SM's issue rate at
// its share of the HBM rate); from ~128 rows the wgmmas. Tried and dropped
// for moving nothing: a separate 10-16-stage weight ring beside a short x
// ring, and clusters of two CTAs multicasting one x tile.
// It launches on the caller's stream, allocates nothing and never
// synchronises, so it captures into CUDA graphs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kKTile = 64;         // K per stage: one 128-byte x row
constexpr int kUnitBytes = 4096;   // one warpgroup's 64 x 64 packed tile
constexpr int kConsumers = 2;      // warpgroups: 128 features per CTA
constexpr int kProducerRegs = 40;  // registers of a producer warpgroup
constexpr int kConsumerRegs = 232; // and of a consumer's, where rebalanced

// Token tiles of 128 and more hold 64 or more accumulators a thread: their
// CTA has a whole producer warpgroup (384 threads, 168 registers each at
// launch), which gives its registers to the consumers with setmaxnreg
// (40 / 232, the whole file). Narrower tiles take a lone producer warp
// (288 threads) and need no rebalancing.
template <int BM>
struct Shape {
  static constexpr bool kRebalance = BM >= 128;
  static constexpr int kThreads = kConsumers * 128 + (kRebalance ? 128 : 32);
};
constexpr int kMaxSegs = 3;        // linears one launch takes
constexpr int kOutStride = 136;    // bf16 per staged output row (+16 B)

struct Segments {
  const int8_t* w[kMaxSegs];
  const float* s[kMaxSegs];
  const __nv_bfloat16* b[kMaxSegs];
  __nv_bfloat16* y[kMaxSegs];
  int n[kMaxSegs];            // output features
  int tile0[kMaxSegs + 1];    // first 128-feature tile of each, then total
  int count;
};

// a[i] for a runtime i without indexing the parameter space
template <class T, int L>
__device__ __forceinline__ T pick(const T (&a)[L], int i) {
  T v = a[0];
#pragma unroll
  for (int j = 1; j < L; ++j)
    if (i == j) v = a[j];
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` contiguous bytes global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the (c0 = k, c1 = token) box of x's tensor map -> shared, on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// wgmma B descriptor of a K-major tile with the 128-byte swizzle (rows of
// 128 bytes, 8-row groups 1024 bytes apart), as the TMA load wrote it
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// 4 int8 (one word, low byte first) -> 2 bf16 pairs, exactly: byte i
// biased by 128 into a float 2^23 + (q + 128), minus 2^23 + 128 gives q;
// a float holding an integer |q| <= 127 has zero low 16 bits, so its high
// half is q in bf16
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t f0 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u)) - 8388736.f);
  const uint32_t f1 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541u)) - 8388736.f);
  const uint32_t f2 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542u)) - 8388736.f);
  const uint32_t f3 = __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543u)) - 8388736.f);
  lo = __byte_perm(f0, f1, 0x7632u);
  hi = __byte_perm(f2, f3, 0x7632u);
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 features x N tokens, f32, registers) += A (64 x 16 bf16, the
// registers a0-a3) * B (N x 16 bf16, K-major in shared memory, `db`); one
// warpgroup
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                         uint32_t a2, uint32_t a3, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      " {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      " {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95}, "
      " {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0,
                                              uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, "
      "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      " {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// One CTA: the 128-feature tile `tile` of the concatenated segments (token
// tile `mt` of m_tiles) over the K tiles [kt0, kt0 + per_split) of split
// blockIdx.y. BM: tokens per tile (wgmma's N); S: ring stages; MINB: CTAs
// per SM the registers are capped for.
template <int BM, int S, int MINB>
__global__ void __launch_bounds__(Shape<BM>::kThreads, MINB)
    w8a16_wgmma(const __grid_constant__ CUtensorMap xmap,
                const Segments segs, float* __restrict__ part,
                int* __restrict__ counters, int M, int KT, int m_tiles,
                int per_split) {
  constexpr int kXBytes = BM * 128;  // one stage's x tile
  constexpr int kAcc = BM / 2;       // accumulators per consumer thread
  static_assert(BM % 8 == 0 && BM <= 256, "wgmma N");
  static_assert(BM * kOutStride * 2 <= S * (kXBytes + kConsumers *
                                            kUnitBytes), "staging");
  extern __shared__ unsigned char smem_raw[];
  __shared__ int s_last;
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = smem;                          // [S][BM][128 B]
  unsigned char* ws = smem + S * kXBytes;            // [S][2][4096 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + S * kConsumers *
                                               kUnitBytes);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int tile = blockIdx.x / m_tiles, mt = blockIdx.x - tile * m_tiles;
  int seg = 0;
#pragma unroll
  for (int j = 1; j < kMaxSegs; ++j)
    if (j < segs.count && tile >= segs.tile0[j]) seg = j;
  const int local = tile - pick(segs.tile0, seg);
  const int N = pick(segs.n, seg);
  // the second warpgroup idles on a segment's odd last 64-feature unit
  const int nwg = min(kConsumers, (N + 63) / 64 - 2 * local);
  const int splits = gridDim.y, split = blockIdx.y;
  const int kt0 = split * per_split;
  const int nk = min(KT, kt0 + per_split) - kt0;
  const int m0 = mt * BM;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * nwg);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer: one lane issues the copies
    if constexpr (Shape<BM>::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    if (tid == kConsumers * 128) {
      const int8_t* w0 =
          pick(segs.w, seg) + ((int64_t)2 * local * KT + kt0) * kUnitBytes;
      for (int i = 0; i < nk; ++i) {
        const int st = i % S;
        if (i >= S) mbar_wait(&empty[st], ((i / S) - 1) & 1);
        mbar_expect_tx(&full[st], nwg * kUnitBytes + kXBytes);
        for (int j = 0; j < nwg; ++j)
          bulk_load(ws + (st * kConsumers + j) * kUnitBytes,
                    w0 + ((int64_t)j * KT + i) * kUnitBytes, kUnitBytes,
                    &full[st]);
        tma_load_2d(xs + st * kXBytes, &xmap, (kt0 + i) * kKTile, m0,
                    &full[st]);
      }
    }
    return;
  }
  if constexpr (Shape<BM>::kRebalance)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  if (wg >= nwg) return;

  const int t = tid & 127;
  const int nthreads = 128 * nwg;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  uint32_t fa[16], fb[16];  // A fragments of two stages in flight

  // stage i: wait for its tiles, convert this thread's 32 weight bytes into
  // four k16 fragments, issue the four wgmmas; then wait for stage i - 1's
  // group and release its slot
  auto step = [&](int i, uint32_t(&a)[16]) {
    const int st = i % S;
    mbar_wait(&full[st], (i / S) & 1);
    const uint4* wp = reinterpret_cast<const uint4*>(
        ws + (st * kConsumers + wg) * kUnitBytes);
    const uint4 r0 = wp[t], r1 = wp[128 + t];
    i8x4_to_bf16(r0.x, a[0], a[1]);
    i8x4_to_bf16(r0.y, a[2], a[3]);
    i8x4_to_bf16(r0.z, a[4], a[5]);
    i8x4_to_bf16(r0.w, a[6], a[7]);
    i8x4_to_bf16(r1.x, a[8], a[9]);
    i8x4_to_bf16(r1.y, a[10], a[11]);
    i8x4_to_bf16(r1.z, a[12], a[13]);
    i8x4_to_bf16(r1.w, a[14], a[15]);
    const uint64_t db = desc_sw128(xs + st * kXBytes);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 4; ++s)  // k16 step s: 32 bytes into the x rows
      wgmma_rs<BM>(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
                   db + 2 * s);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % S]);
  };
  int i = 0;
  for (; i + 1 < nk; i += 2) {
    step(i, fa);
    step(i + 1, fb);
  }
  if (i < nk) step(i, fa);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // accumulator i: feature 16 w + g + 8 ((i >> 1) & 1) of this warpgroup's
  // 64, token 8 (i >> 2) + 2 q + (i & 1) of the tile (w: warp, g = lane /
  // 4, q = lane % 4). Split partial sums: float4 j of thread t at [j][t]
  // of the (CTA, split, warpgroup) block
  if (splits > 1) {
    float4* mine = reinterpret_cast<float4*>(part) +
                   ((int64_t)(blockIdx.x * splits + split) * kConsumers +
                    wg) * (32 * kAcc);
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j)
      __stcg(mine + j * 128 + t, make_float4(acc[4 * j], acc[4 * j + 1],
                                             acc[4 * j + 2], acc[4 * j + 3]));
    __threadfence();
    named_sync(nthreads);
    if (tid == 0)
      s_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
    named_sync(nthreads);
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float4* p = reinterpret_cast<const float4*>(part) +
                        ((int64_t)(blockIdx.x * splits + sp) * kConsumers +
                         wg) * (32 * kAcc);
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        const float4 v = __ldcg(p + j * 128 + t);
        acc[4 * j] += v.x;
        acc[4 * j + 1] += v.y;
        acc[4 * j + 2] += v.z;
        acc[4 * j + 3] += v.w;
      }
    }
    if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
  }

  const int w = t >> 5, g = lane >> 2, q = lane & 3;
  const int f0 = local * 128 + wg * 64 + 16 * w + g;  // and f0 + 8
  const float* sv = pick(segs.s, seg);
  const __nv_bfloat16* bv = pick(segs.b, seg);
  float sc[2], bi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = f0 + 8 * e;
    sc[e] = n < N ? bf16_round(sv[n]) : 0.f;
    bi[e] = (bv != nullptr && n < N) ? __bfloat162float(bv[n]) : 0.f;
  }
  __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(smem);
  named_sync(nthreads);  // every warpgroup is done with the ring
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int e = (j >> 1) & 1;
    const int row = 8 * (j >> 2) + 2 * q + (j & 1);
    __nv_bfloat16 v = __float2bfloat16(bf16_round(acc[j]) * sc[e]);
    if (bv != nullptr)
      v = __float2bfloat16(__bfloat162float(v) + bi[e]);
    out[row * kOutStride + wg * 64 + 16 * w + g + 8 * e] = v;
  }
  named_sync(nthreads);
  __nv_bfloat16* y = pick(segs.y, seg);
  const int fb0 = local * 128;
  const int cols = min(128, N - fb0);
  const int rows = min(BM, M - m0);
  if (N % 8 == 0) {  // whole 16-byte pieces of each output row
    for (int c = tid; c < rows * 16; c += nthreads) {
      const int r = c >> 4, ch = c & 15;
      if (ch * 8 < cols)
        *reinterpret_cast<uint4*>(y + (int64_t)(m0 + r) * N + fb0 + ch * 8) =
            *reinterpret_cast<const uint4*>(out + r * kOutStride + ch * 8);
    }
  } else {
    for (int c = tid; c < rows * 128; c += nthreads) {
      const int r = c >> 7, f = c & 127;
      if (f < cols) y[(int64_t)(m0 + r) * N + fb0 + f] = out[r * kOutStride + f];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, from the driver library the runtime has
// loaded (no link-time dependency on libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

template <int BM, int S, int MINB>
constexpr size_t smem_bytes() {
  return (size_t)S * (BM * 128 + kConsumers * kUnitBytes) +
         2 * S * sizeof(uint64_t) + 1024;  // + alignment
}

template <int BM, int S, int MINB>
int launch(const CUtensorMap& map, const Segments& segs, float* part,
           int* counters, int M, int KT, int m_tiles, int splits,
           int per_split, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, S, MINB>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a16_wgmma<BM, S, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(segs.tile0[segs.count] * m_tiles, splits);
  w8a16_wgmma<BM, S, MINB><<<grid, Shape<BM>::kThreads, smem, stream>>>(
      map, segs, part, counters, M, KT, m_tiles, per_split);
  return (int)cudaGetLastError();
}

// CTAs of an instance that fit on one SM (registers, shared memory)
template <int BM, int S, int MINB>
int occupancy() {
  constexpr size_t smem = smem_bytes<BM, S, MINB>();
  if (cudaFuncSetAttribute(w8a16_wgmma<BM, S, MINB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, w8a16_wgmma<BM, S, MINB>, Shape<BM>::kThreads, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

// the instances by token tile: (BM, ring stages, CTAs an SM the registers
// are capped for); ops/kernels.py W8A16_TOKEN_TILES lists the same tiles
#define VOX_W8A16_INSTANCES(X) \
  X(8, 8, 2)                   \
  X(16, 8, 2)                  \
  X(32, 8, 2)                  \
  X(64, 8, 1)                  \
  X(128, 8, 1)                 \
  X(192, 6, 1)                 \
  X(256, 5, 1)

}  // namespace

// Plain C entry, loaded with ctypes. x: (M, K) bf16 (16-byte aligned rows:
// K % 8 == 0); up to three linears (nseg), each a packed weight w_i of
// ceil(N_i / 64) x ceil(K / 64) units, scales s_i, bias b_i (or null) and
// output y_i (M, N_i). bm: the token tile (8, 16, 32, 64, 128, 192, 256),
// M rows in ceil(M / bm) tiles; `splits` K ranges of `per_split` K tiles;
// `part` and `counters` (zero) as ops/kernels.py plan_w8a16 sizes them,
// needed where splits > 1. Returns cudaGetLastError() after the launch (0
// = success), -1 for arguments no instance takes, -2 without the driver's
// tensor-map encoder, 1000 + the CUresult where encoding fails.
extern "C" int vox_w8a16_linear(
    const void* x, const void* w0, const void* w1, const void* w2,
    const void* s0, const void* s1, const void* s2, const void* b0,
    const void* b1, const void* b2, void* y0, void* y1, void* y2, int n0,
    int n1, int n2, int nseg, void* part, void* counters, int M, int K,
    int bm, int splits, int per_split, void* stream) {
  if (M <= 0) return 0;
  if (nseg < 1 || nseg > kMaxSegs || K <= 0 || K % 8 != 0 || splits < 1 ||
      per_split < 1 || (splits > 1 && (part == nullptr || counters == nullptr)))
    return -1;
  const int KT = (K + kKTile - 1) / kKTile;
  if ((int64_t)(splits - 1) * per_split >= KT ||
      (int64_t)splits * per_split < KT)
    return -1;
  Segments segs = {};
  const void* ws[kMaxSegs] = {w0, w1, w2};
  const void* ss[kMaxSegs] = {s0, s1, s2};
  const void* bs[kMaxSegs] = {b0, b1, b2};
  void* ys[kMaxSegs] = {y0, y1, y2};
  const int ns[kMaxSegs] = {n0, n1, n2};
  segs.count = nseg;
  segs.tile0[0] = 0;
  for (int i = 0; i < nseg; ++i) {
    if (ns[i] <= 0 || ws[i] == nullptr || ss[i] == nullptr ||
        ys[i] == nullptr)
      return -1;
    segs.w[i] = (const int8_t*)ws[i];
    segs.s[i] = (const float*)ss[i];
    segs.b[i] = (const __nv_bfloat16*)bs[i];
    segs.y[i] = (__nv_bfloat16*)ys[i];
    segs.n[i] = ns[i];
    segs.tile0[i + 1] = segs.tile0[i] + ((ns[i] + 63) / 64 + 1) / 2;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kKTile, (cuuint32_t)bm};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int m_tiles = (M + bm - 1) / bm;
  float* p = (float*)part;
  int* c = (int*)counters;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bm) {
#define VOX_W8A16_CASE(BM, S, MINB)                                          \
  case BM:                                                                   \
    return launch<BM, S, MINB>(map, segs, p, c, M, KT, m_tiles, splits,     \
                               per_split, st);
    VOX_W8A16_INSTANCES(VOX_W8A16_CASE)
#undef VOX_W8A16_CASE
    default:
      return -1;
  }
}

// CTAs of the token tile `bm`'s instance that fit on one SM (-1: no such
// instance)
extern "C" int vox_w8a16_occupancy(int bm) {
  switch (bm) {
#define VOX_W8A16_CASE(BM, S, MINB) \
  case BM:                          \
    return occupancy<BM, S, MINB>();
    VOX_W8A16_INSTANCES(VOX_W8A16_CASE)
#undef VOX_W8A16_CASE
    default:
      return -1;
  }
}
